"""Entry point ``frame_engine``, a closed loop: ``FrameDenoiseEngine`` on
``plan_for(n_frames=frames_per_dispatch)``. Each dispatch submits
``frames_per_dispatch`` pool frames and calls ``step()``; the loop waits
only on the completion event of the dispatch ``in_flight`` back, so the
host runs ahead of the card. One span ``engine`` a dispatch.

Mix parameters: ``frames_per_dispatch``, ``in_flight``,
``warmup_dispatches``, ``check_frames`` (rows drawn from the seed over every
dispatch of the window, compared with the reference's per-frame filter).
"""
from __future__ import annotations

import time
from collections import deque

import torch

from harness.check import Verdict
from harness.drive import Done, bg_config, sync
from harness.stats import Reservoir


def drive(run, pool, seed, seconds, device, precision, tracer, t_start):
    from repro_torch.plan import plan_for
    from repro_torch.serving.frames import FrameDenoiseEngine, FrameRequest

    cfg, tr = run.config, run.traffic
    h, w = int(cfg["height"]), int(cfg["width"])
    per, depth = int(tr["frames_per_dispatch"]), int(tr["in_flight"])
    n_pool = pool.shape[0]
    plan = plan_for(bg_config(cfg), h, w, n_frames=per, cache=False, device=device,
                    precision=precision)
    run.plan = plan.describe()
    run.temporal = False
    eng = FrameDenoiseEngine(plan=plan, max_batch=per)
    uid = 0

    def dispatch():
        nonlocal uid
        for _ in range(per):
            eng.submit(FrameRequest(uid, pool[uid % n_pool]))
            uid += 1
        return eng.step()

    for _ in range(int(tr["warmup_dispatches"])):
        dispatch()
    sync(device)

    sample = Reservoir(int(tr["check_frames"]), seed)
    pending: deque = deque()
    done = []
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    d = 0
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        done = dispatch()
        pending.append(Done(device))
        b = time.perf_counter()
        run.span("engine", a, b)
        slot = sample.offer(d)
        if slot is not None:
            req = done[sample.rng.randrange(len(done))]
            sample.put(slot, (req.uid % n_pool, req.result.clone()))
            c = time.perf_counter()
            run.span("sample", b, c)
            b = c
        if len(pending) > depth:
            pending.popleft().wait()
            run.span("wait", b, time.perf_counter())
        d += 1
    while pending:
        pending.popleft().wait()
    run.window_s = time.perf_counter() - t0
    run.attempted = run.completed = d * per
    if tracer is not None:
        run.trace = tracer.stop()
    del eng, plan, done
    return sample.items


def check(run, ref, pool, items):
    bg = ref.BG(run.config)
    verdict = Verdict(run.config["limits"])
    for lo in range(0, len(items), 4):
        chunk = items[lo:lo + 4]
        idx = torch.tensor([j for j, _ in chunk], device=pool.device)
        expect = ref.filter_frames(pool[idx], bg)
        verdict.add(torch.stack([out for _, out in chunk]), expect)
    return verdict
