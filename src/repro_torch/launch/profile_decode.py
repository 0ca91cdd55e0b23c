"""Where a decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch tinyllama-1.1b] [--slots 8] [--prompt-len 300] [--steps 20]

Fills every slot of an engine (the paged layout where the family is
pageable, else the dense one) with one request (random weights, random
prompts from ``--seed``), lets prefill finish, then times ``--steps`` decode
steps three ways: wall clock with a device sync after each step (step time),
wall clock of the host's dispatch alone (no sync), and under
``torch.profiler`` (device time by kernel, summed). The device's idle share
is 1 - device time / step time. Prints one line per measure and the top
kernels, and a JSON summary line last.
"""
import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=300)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..configs import config, smoke_config
    from ..models import api
    from ..runtime.engine import Engine, EngineConfig, RequestSpec

    cfg = smoke_config(args.arch) if args.smoke else config(args.arch)
    layout = "paged" if api.supports_paged_kv(cfg) else "dense"
    bucket = 1 << max(args.prompt_len - 1, 1).bit_length()
    tokens = 3 * args.steps + 8
    engine = Engine(cfg, EngineConfig(
        slots=args.slots, prompt_buckets=(bucket,),
        max_seq=bucket + tokens, kv_layout=layout, page_size=16),
        params=api.init_params(cfg, args.seed, device=args.device),
        device=args.device)
    dev = engine.device
    rng = np.random.default_rng(args.seed)

    def fill():
        for _ in range(args.slots):
            engine.submit(RequestSpec(tuple(rng.integers(
                0, cfg.vocab, args.prompt_len).tolist()), tokens))
        engine.step()               # admits and prefills every slot
        if any(r is None for r in engine.slots_req):
            raise RuntimeError("the pool did not admit every slot at once")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fill()
    for _ in range(3):
        engine.step()
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
        sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    sync()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            engine.step()
        sync()

    # device-side events only (kernels, copies): a CPU op's own device time
    # is the time of the kernels it launched, which appear again as events
    rows = sorted(((float(e.self_device_time_total), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if dev.type != "cuda":
        print(f"decode step: {step_ms:.3f} ms on {dev}; device time not "
              f"measured (no card)")
        return
    device_ms = sum(r[0] for r in rows) / 1e3 / args.steps
    print(f"decode step: {step_ms:.3f} ms with a sync per step, host "
          f"dispatch {host_ms:.3f} ms, device {device_ms:.3f} ms "
          f"(idle share {max(0.0, 1 - device_ms / step_ms):.3f}); "
          f"slots={args.slots} context~{bucket} arch={cfg.name} "
          f"kv_layout={layout} on {dev} "
          f"({torch.cuda.get_device_name(dev)})")
    for us, n, name in rows[:args.top]:
        print(f"  {us / 1e3 / args.steps:9.4f} ms/step  {n // args.steps:5d} "
              f"calls/step  {name[:90]}")
    print(json.dumps({"step_ms": step_ms, "host_dispatch_ms": host_ms,
                      "device_ms": device_ms,
                      "idle_share": max(0.0, 1 - device_ms / step_ms),
                      "top": [{"name": name, "ms_per_step":
                               us / 1e3 / args.steps,
                               "calls_per_step": n // args.steps}
                              for us, n, name in rows[:args.top]]}))


if __name__ == "__main__":
    main()
