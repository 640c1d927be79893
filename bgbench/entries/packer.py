"""Entry point ``packer``, an open loop: ``MultiStreamPacker`` on
``plan_for(n_frames=streams, temporal=True)``, ``streams`` streams opened at
``alpha``. Every 1/``fps`` s one ``pack()`` of each stream's next frame is
sent at its due time, whatever the card is doing; a timing event after each
pack stamps its completion on the device (``Stamps``). A frame's latency
runs from its due time to its pack's completion. One span ``pack`` a pack.

Stream ``s`` takes pool frame ``(tick + s * stream_stride) % pool_frames``
at each tick. With ``pool_frames >= streams`` and ``stream_stride`` prime to
``pool_frames``, every stream gets a frame of its own at every tick, so
streams whose outputs or carries were swapped cannot compare equal.

Mix parameters: ``fps``, ``streams``, ``alpha``, ``warmup_packs``,
``stream_stride``, ``check_streams`` (streams drawn from the seed, replayed
by the reference from their first frame) and ``check_ticks`` (ticks drawn
from the seed, and the last, at which they are compared).
"""
from __future__ import annotations

import random
import time

import torch

from harness.check import Verdict
from harness.drive import Stamps, bg_config, sync, wait_until
from harness.stats import Reservoir


def frame_index(tick: int, stream: int, traffic: dict, n_pool: int) -> int:
    return (tick + stream * int(traffic["stream_stride"])) % n_pool


def drive(run, pool, seed, seconds, device, precision, tracer, t_start):
    from repro_torch.plan import plan_for
    from repro_torch.video.session import MultiStreamPacker

    cfg, tr = run.config, run.traffic
    h, w = int(cfg["height"]), int(cfg["width"])
    n, fps, alpha = int(tr["streams"]), float(tr["fps"]), float(tr["alpha"])
    n_pool = pool.shape[0]
    period = 1.0 / fps
    plan = plan_for(bg_config(cfg), h, w, n_frames=n, temporal=True, cache=False, device=device,
                    precision=precision)
    run.plan = plan.describe()
    run.temporal = True
    packer = MultiStreamPacker(plan=plan)
    for s in range(n):
        packer.open(s, alpha=alpha)

    def frames_at(tick):
        return {s: pool[frame_index(tick, s, tr, n_pool)] for s in range(n)}

    warm = int(tr["warmup_packs"])
    for tick in range(warm):
        packer.pack(frames_at(tick))
    sync(device)

    rng = random.Random(seed)
    checked = sorted(rng.sample(range(n), min(n, int(tr["check_streams"]))))
    n_ticks = int(round(seconds * fps))
    sample = Reservoir(int(tr["check_ticks"]), seed)
    kept_last = None
    dues = []
    stamps = Stamps(device)
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter() + 0.002
    run.setup_s = t0 - t_start
    for k in range(n_ticks):
        due = t0 + k * period
        a = time.perf_counter()
        if a < due:
            wait_until(due)
            run.span("sleep", a, time.perf_counter())
        a = time.perf_counter()
        run.lateness_ms.append((a - due) * 1e3)
        frames = frames_at(warm + k)
        b = time.perf_counter()
        results = packer.pack(frames)
        stamps.mark()
        c = time.perf_counter()
        run.span("pack", b, c)
        dues.append(due)
        slot = sample.offer(k)
        if slot is not None or k == n_ticks - 1:
            kept = (warm + k, {s: results[s].clone() for s in checked})
            if slot is not None:
                sample.put(slot, kept)
            if k == n_ticks - 1:
                kept_last = kept
            run.span("sample", c, time.perf_counter())
        del results
    finished = run.packs
    finished.extend(zip(dues, stamps.times()))
    run.window_s = max(t for _, t in finished) - t0
    run.attempted = n_ticks * n
    run.completed = len(finished) * n
    for due, t in finished:
        run.latencies_ms.extend([(t - due) * 1e3] * n)
    if tracer is not None:
        run.trace = tracer.stop()
    del packer, plan
    items = {tick: outs for tick, outs in sample.items}
    if kept_last is not None:
        items[kept_last[0]] = kept_last[1]
    return checked, items, warm + n_ticks


def check(run, ref, pool, state):
    checked, items, total_ticks = state
    tr, n_pool = run.traffic, pool.shape[0]
    replay = ref.TemporalReplay(ref.BG(run.config), float(tr["alpha"]))
    verdict = Verdict(run.config["limits"])
    for tick in range(total_ticks):
        idx = torch.tensor([frame_index(tick, s, tr, n_pool) for s in checked], device=pool.device)
        expect = replay.step(pool[idx], quantize=tick in items)
        if tick in items:
            verdict.add(torch.stack([items[tick][s] for s in checked]), expect)
    return verdict
