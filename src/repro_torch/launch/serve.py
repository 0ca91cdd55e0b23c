"""Serving launcher: continuous-batching engine over the UPIR decode plan
(PyTorch port).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --paged --requests 8 --slots 4 --prompt-len 16 --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --kv-layout dense --smoke --device cpu

Runs on the card by default; ``--device cpu`` (with ``--smoke``) runs the
plain attention path on the CPU. The flags are the JAX package launcher's for
the features this slice ports: ``--temperature`` / ``--top-k`` / ``--top-p`` /
``--seed`` turn on sampling, ``--eos-id`` finishes requests on an EOS token,
``--sequential`` also runs the one-request-at-a-time path for comparison.
``--kv-layout`` picks the KV layout: ``paged`` (the default for a pageable
family; ``--paged``, the reference's flag, says the same) or ``dense`` (the
default, and the only layout, for the hybrid family).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="KV horizon (default: prompt bucket + tokens)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV layout (same as --kv-layout paged)")
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default=None,
                    help="KV layout (default: paged where the family is "
                         "pageable, else dense)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical KV page")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0,
                    help="0 = full vocab; else sample the k largest logits")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="1.0 = off; else nucleus sampling")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (per-request keys fold in rid)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="finish requests on this token (-1 = run to budget)")
    ap.add_argument("--sequential", action="store_true",
                    help="also run the one-request-at-a-time path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from ..configs import config, smoke_config
    from ..models import api
    from ..runtime.engine import (Engine, EngineConfig, RequestSpec,
                                  serve_sequential)
    from ..runtime.sampling import SamplingParams

    cfg = smoke_config(args.arch) if args.smoke else config(args.arch)
    bucket = 1 << max(args.prompt_len - 1, 1).bit_length()
    max_seq = args.max_seq or bucket + args.tokens
    if args.temperature <= 0 and (args.top_k or args.seed
                                  or args.top_p < 1.0):
        ap.error("--top-k/--top-p/--seed only apply to sampled decode: "
                 "set --temperature > 0 (temperature 0 is greedy)")
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed) \
        if args.temperature > 0 else None
    eos_id = args.eos_id if args.eos_id >= 0 else None

    if args.paged and args.kv_layout == "dense":
        ap.error("--paged and --kv-layout dense contradict each other")
    layout = "paged" if args.paged else args.kv_layout
    if layout is None:
        layout = "paged" if api.supports_paged_kv(cfg) else "dense"
    params = api.init_params(cfg, 0, device=args.device)
    engine = Engine(cfg, EngineConfig(slots=args.slots,
                                      prompt_buckets=(bucket,),
                                      max_seq=max_seq, kv_layout=layout,
                                      page_size=args.page_size),
                    params=params, device=args.device)
    rng = np.random.default_rng(0)
    specs = [RequestSpec(
        prompt=tuple(rng.integers(0, cfg.vocab, size=args.prompt_len)
                     .tolist()),
        max_new_tokens=args.tokens, sampling=sampling, eos_id=eos_id)
        for _ in range(args.requests)]

    # warm up outside the measured run
    engine.run([RequestSpec((1,) * args.prompt_len, 2)
                for _ in range(args.slots)])
    engine.reset_stats()

    requests = engine.run(specs)
    st = engine.stats()
    mode = f"sampled(T={args.temperature},k={args.top_k},p={args.top_p})" \
        if sampling else "greedy"
    print(f"engine: arch={cfg.name} device={engine.device} "
          f"caps={','.join(st['capabilities']) or '-'} "
          f"requests={args.requests} slots={args.slots} "
          f"prompt={args.prompt_len} tokens={args.tokens} mode={mode} "
          f"policy={st['policy']} kv_layout={layout}")
    print(f"  completed={st['completed']} eos_finished={st['eos_finished']} "
          f"rejected={st['rejected']} decode_steps={st['decode_steps']} "
          f"recycles={st['recycles']} evictions={st.get('evictions', 0)}")
    print(f"  occupancy={st['batch_occupancy']:.2f} "
          f"throughput={st['tokens_per_s']:.1f} tok/s "
          f"plan_cache_hit_rate={st['plan_cache']['hit_rate']:.2f}")
    done = [r for r in requests if r.state == "done"]
    if done:
        print("  sample:", engine.finalize_request(done[0])[:16])
    if args.sequential:
        seq = serve_sequential(cfg, params, requests, max_seq=max_seq,
                               prompt_buckets=(bucket,),
                               page_size=args.page_size, kv_layout=layout,
                               device=args.device)
        same = all(engine.finalize_request(r) == seq["tokens"][r.rid]
                   for r in done)
        print(f"sequential: throughput={seq['tokens_per_s']:.1f} tok/s "
              f"({st['tokens_per_s'] / max(seq['tokens_per_s'], 1e-9):.2f}x "
              f"engine speedup), streams identical: {same}")


if __name__ == "__main__":
    main()
