"""Device us a frame of the bf16 route's two storage casts (``plan.py::_cast``),
over the frames completed in the traced window. Each is a PyTorch copy
kernel, named in the trace (torch 2.11, H100):

  the frames to bf16   ``vectorized_elementwise_kernel<8,
                       at::native::bfloat16_copy_kernel_cuda(...)...>``
  the output to fp32   ``unrolled_elementwise_kernel<at::native::
                       direct_copy_kernel_cuda(...)..., LoadWithCast<1>,
                       StoreWithCast<1>>``

The engine's stack (``CatArrayBatchedCopy_vectorized``) and the sampled
outputs' copies (``Memcpy DtoD``) are other ops and do not count."""


def _is_cast(name: str) -> bool:
    return "bfloat16_copy_kernel_cuda" in name or (
        "direct_copy_kernel_cuda" in name and "WithCast" in name)


def read(run):
    if run.trace is None or "engine" not in run.spans or run.completed == 0:
        return None
    seconds = sum(b - a for name, a, b in run.trace.ops if _is_cast(name))
    if seconds <= 0:
        return None
    return 1e6 * seconds / run.completed
