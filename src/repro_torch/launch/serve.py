"""Serving launcher of the port: the ``engine`` subcommand.

Brings up one continuous-batching engine (paged, or with ``--contiguous``
the contiguous KV layout) for an architecture and serves a batched-prompt
workload, as the JAX package's ``serve engine``
does, with the same flags and the same rule that a config of more than 5e7
parameters is served at its ``reduced()`` size::

    PYTHONPATH=src python -m repro_torch.launch.serve engine --arch tiny-m --requests 12
    PYTHONPATH=src python -m repro_torch.launch.serve engine --arch tiny-s --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve engine --contiguous --device cpu

Weights are random, drawn by ``Model.init`` from a seeded generator.  The
run is on the card unless ``--device cpu`` is given; there each fused
decode dispatch is one CUDA-graph replay.  ``--temperature``, ``--top-k``,
``--top-p`` and ``--gen-seed`` serve every request sampled, with the JAX
package's streams for the same seed::

    PYTHONPATH=src python -m repro_torch.launch.serve engine --device cpu \
        --temperature 0.8 --top-k 50 --top-p 0.95 --gen-seed 7

``--draft-member ARCH`` serves through routed speculative decoding: ARCH
(full size, as the JAX launcher builds it, random weights of seed 0) drafts
``--spec-k`` tokens a round for the target, paged layout only::

    PYTHONPATH=src python -m repro_torch.launch.serve engine --arch tiny-m \
        --draft-member tiny-s --device cpu --requests 6 --batch-prompt 3

The ``online`` and ``http`` modes raise ``NotImplementedError``: the control
plane is not ported yet.
"""
import argparse
import sys
import time


def engine_main(argv):
    ap = argparse.ArgumentParser(prog="serve engine")
    ap.add_argument("--arch", default="tiny-s")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-prompt", type=int, default=0,
                    help="pack N queries per request (batch prompting); 0 = single")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens generated per fused decode dispatch")
    ap.add_argument("--contiguous", action="store_true",
                    help="use the contiguous KV layout instead of the paged one")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page in the paged layout")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (smoke) config of a big arch")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest-probability tokens (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = all)")
    ap.add_argument("--gen-seed", type=int, default=0,
                    help="PRNG seed for sampled decoding")
    ap.add_argument("--draft-member", default="",
                    help="speculative-decoding draft arch (paged layout only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculation depth with --draft-member")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.serving.batcher import BatchPromptFormatter
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.generation import GenerationConfig

    cfg = get_arch(args.arch)
    if args.reduced or cfg.param_count() > 5e7:
        cfg = cfg.reduced()
    if cfg.vocab_size < 259 or cfg.enc_dec or cfg.frontend:
        raise SystemExit(f"{cfg.name}: byte-tokenizer text serving needs a plain "
                         f"decoder with vocab ≥ 259 (use tiny-s/m/l or --reduced dense archs)")
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    if args.draft_member:
        from repro_torch.serving.speculative import SpeculativeEngine

        if args.contiguous:
            raise SystemExit("--draft-member needs the paged KV layout (drop --contiguous)")
        dmodel = Model(get_arch(args.draft_member), device=args.device)
        dmodel.init(torch.Generator(device=dmodel.device).manual_seed(0))
        engine = SpeculativeEngine(model, dmodel, max_slots=args.slots, max_len=args.max_len,
                                   spec_k=args.spec_k, page_size=args.page_size,
                                   device=model.device)
    else:
        engine = ServingEngine(model, max_slots=args.slots, max_len=args.max_len,
                               decode_block=args.decode_block, paged=not args.contiguous,
                               page_size=args.page_size, device=model.device)
    fmt = BatchPromptFormatter("Answer each question.")

    gen = None
    if args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0:
        gen = GenerationConfig(max_new=args.max_new, temperature=args.temperature,
                               top_k=args.top_k, top_p=args.top_p, seed=args.gen_seed)
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(args.requests):
        qs = [f"{rng.integers(0, 99)}+{rng.integers(0, 99)}"
              for _ in range(max(args.batch_prompt, 1))]
        prompts.append(fmt.format(qs) if args.batch_prompt else fmt.tokenizer.encode(qs[0]))
    reqs = [Request(rid=i, tokens=p, max_new=args.max_new, gen=gen)
            for i, p in enumerate(prompts)]

    t0 = time.time()
    engine.serve(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    tok = fmt.tokenizer
    done = sum(r.done for r in reqs)
    out_toks = sum(len(r.out_tokens) for r in reqs)
    print(f"{cfg.name}: served {done}/{len(reqs)} requests "
          f"({out_toks} tokens) in {dt:.1f}s via {args.slots} slots on {model.device}")
    occ = engine.kv_occupancy()
    if occ["paged"]:
        print(f"  kv pages: {occ['pages_used']}/{occ['n_pages']} live "
              f"(peak {occ['peak_pages']}), {occ['prefix_shares']} prefix "
              f"shares, {occ['cow_forks']} CoW forks")
    else:
        print(f"  kv: contiguous, {occ['kv_bytes'] / 2**20:.1f} MiB committed")
    if args.draft_member:
        print(f"  speculative: k={engine.spec_k} rounds={engine.n_rounds} "
              f"accept={engine.accept_rate():.2f} bonus={engine.n_bonus}")
    for r in reqs[:3]:
        print(f"  req{r.rid}: prompt {len(r.tokens)} toks -> "
              f"{tok.decode(r.out_tokens)[:48]!r}")


def main():
    argv = sys.argv[1:]
    if argv and argv[0] in ("online", "http"):
        raise NotImplementedError(f"serve {argv[0]}: the control plane is not ported yet")
    if argv and argv[0] == "engine":
        argv = argv[1:]
    engine_main(argv)


if __name__ == "__main__":
    main()
