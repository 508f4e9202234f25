"""Serving launcher of the port: the ``engine``, ``online`` and ``http`` subcommands.

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

``online`` — the full online serving layer, with the JAX launcher's flags:
build the pool a spec describes, fit the modeling stage once, then stream a
Poisson arrival workload through the pluggable policy under a rolling
budget, the response cache and the circuit breakers.  The router and the
semantic cache run on ``--device`` (the card unless ``cpu`` is given)::

    PYTHONPATH=src python -m repro_torch.launch.serve online --device cpu \
        --qps 25 --duration 8 --n-train 192 --coreset 32
    PYTHONPATH=src python -m repro_torch.launch.serve online --policy routellm --device cpu

``http`` — the OpenAI-compatible HTTP front end (``repro_torch.http``), with
the JAX launcher's flags: fit the same control plane, then serve it over the
wire — ``POST /v1/chat/completions`` (SSE streaming with ``"stream":
true``), ``GET /v1/models``, ``GET /healthz`` and Prometheus ``GET
/metrics`` — until SIGINT/SIGTERM (or ``--max-seconds``); ``--port 0`` binds
an ephemeral port, printed on the ``listening on`` line::

    PYTHONPATH=src python -m repro_torch.launch.serve http --device cpu --port 0 \
        --max-seconds 5 --n-train 192 --coreset 32
    curl -N localhost:8000/v1/chat/completions -d \
        '{"messages":[{"role":"user","content":"#7"}],"stream":true}'
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


def _add_robust_flags(ap):
    """Shared online/http uncertainty-robust scheduling flags (they land on
    the PolicySpec params, so --spec files can declare the same fields)."""
    ap.add_argument("--robust-lambda", type=float, default=None,
                    help="uncertainty penalty λ of the robust frontier walk "
                         "(utility − λ·σ); 0 = the point-estimate walk "
                         "(docs/robustness.md)")
    ap.add_argument("--cost-margin", type=float, default=None,
                    help="worst-case budget margin: the walk draws the window "
                         "budget down at cost·(1+margin)")


def _apply_robust_flags(prog, spec, args):
    if args.robust_lambda is None and args.cost_margin is None:
        return
    params = dict(spec.policy.params)
    if args.robust_lambda is not None:
        params["robust"] = args.robust_lambda
    if args.cost_margin is not None:
        params["cost_margin"] = args.cost_margin
    spec.policy.params = params


def _add_generation_flags(ap):
    """Shared online/http sampling + speculative-decoding flags (they land on
    the PoolSpec, so --spec files can declare the same fields)."""
    ap.add_argument("--temperature", type=float, default=None,
                    help="default sampling temperature for real pool members "
                         "(0 = greedy)")
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling mass (1.0 = all)")
    ap.add_argument("--gen-seed", type=int, default=None,
                    help="PRNG seed for sampled decoding")
    ap.add_argument("--draft-member", default=None,
                    help="tiny pool: cheap member that drafts for the more "
                         "expensive ones (routed speculative decoding)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculation depth with --draft-member (default 4)")


def _apply_generation_flags(prog, spec, args):
    if args.temperature is not None:
        spec.pool.temperature = args.temperature
    if args.top_p is not None:
        spec.pool.top_p = args.top_p
    if args.gen_seed is not None:
        spec.pool.gen_seed = args.gen_seed
    if args.draft_member is not None:
        if spec.pool.kind != "tiny":
            raise SystemExit(f"{prog}: --draft-member needs the tiny real "
                             f"pool (kind='tiny'), not {spec.pool.kind!r}")
        spec.pool.draft_member = args.draft_member
    if args.spec_k is not None:
        spec.pool.spec_k = args.spec_k


def _online_spec(args):
    """Resolve the RunSpec: --spec JSON (file or inline) as the base, legacy
    per-field flags as a deprecation shim layered on top."""
    from repro_torch.api import PolicySpec, PoolSpec, RunSpec

    legacy = {k: v for k, v in [("task", args.task), ("family", args.family),
                                ("n_train", args.n_train), ("coreset", args.coreset),
                                ("seed", args.seed)] if v is not None}
    if args.spec:
        if args.spec.lstrip().startswith("{"):
            text = args.spec                 # inline JSON
        else:
            with open(args.spec) as f:       # else a file path: a typo should
                text = f.read()              # fail as file-not-found, not JSON
        spec = RunSpec.from_json(text)
        if legacy:
            print(f"serve online: legacy flags {sorted(legacy)} override the "
                  f"spec (deprecated; prefer editing --spec)")
            if "task" in legacy:
                spec.pool.task = legacy["task"]
            if "family" in legacy:
                spec.pool.family = legacy["family"]
            if "n_train" in legacy:
                spec.pool.n_train = legacy["n_train"]
            if "coreset" in legacy:
                spec.coreset_size = legacy["coreset"]
            if "seed" in legacy:
                spec.seed = spec.pool.seed = legacy["seed"]
    else:
        spec = RunSpec(
            pool=PoolSpec(task=legacy.get("task", "agnews"),
                          family=legacy.get("family", "qwen3"),
                          n_train=legacy.get("n_train", 512), n_val=128,
                          n_test=512, seed=legacy.get("seed", 0)),
            router="knn", coreset_size=legacy.get("coreset", 64),
            seed=legacy.get("seed", 0))
    if args.policy is not None:
        spec.policy = PolicySpec(args.policy)
    return spec


def online_main(argv):
    ap = argparse.ArgumentParser(prog="serve online")
    ap.add_argument("--policy", default=None,
                    help="registered policy name (repro_torch.api.list_policies())")
    ap.add_argument("--spec", default=None,
                    help="RunSpec JSON — a file path or an inline JSON string")
    ap.add_argument("--task", default=None, help="workload benchmark name")
    ap.add_argument("--family", default=None, help="simulated pool family")
    ap.add_argument("--qps", type=float, default=40.0, help="offered load")
    ap.add_argument("--duration", type=float, default=20.0, help="stream length (s, virtual)")
    ap.add_argument("--window", type=float, default=0.25, help="admission window (s)")
    ap.add_argument("--budget-x", type=float, default=3.0,
                    help="budget rate = qps × cheapest-state cost × this factor")
    ap.add_argument("--repeat-frac", type=float, default=0.2,
                    help="fraction of arrivals re-asking an earlier query (cache hits)")
    ap.add_argument("--realtime", action="store_true",
                    help="pace against the wall clock behind a live arrival thread")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engines per pool member (ReplicaSet when > 1)")
    ap.add_argument("--autoscale", action="store_true",
                    help="backlog-driven replica autoscaling (ReplicaSet."
                         "scale_to between --min-replicas and --max-replicas)")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscale floor (default 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling (default 4 with --autoscale)")
    ap.add_argument("--semantic-cache", action="store_true",
                    help="embedding-space near-duplicate response cache "
                         "(repro_torch.serving.semcache; see docs/caching.md)")
    ap.add_argument("--sim-threshold", type=float, default=None,
                    help="semantic-cache cosine hit threshold (default 0.92)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="wrap every pool member in a seeded ChaosMember fault "
                         "injector (latency noise everywhere, a short error "
                         "burst on the most expensive member) — the smoke "
                         "suite's degraded-path leg (docs/robustness.md)")
    _add_generation_flags(ap)
    _add_robust_flags(ap)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--coreset", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the router and the semantic cache: "
                         "cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.api import Gateway, UnknownPolicyError, get_policy, list_policies
    from repro_torch.data import BENCHMARKS
    from repro_torch.serving.online import OnlineConfig, poisson_arrivals

    if args.qps <= 0:
        raise SystemExit("serve online: --qps must be positive")
    spec = _online_spec(args)
    if args.replicas is not None:
        spec.pool.replicas = args.replicas
    if args.min_replicas is not None:
        spec.pool.min_replicas = args.min_replicas
    if args.max_replicas is not None:
        spec.pool.max_replicas = args.max_replicas
    if args.autoscale and spec.pool.max_replicas <= 0:
        spec.pool.max_replicas = 4               # sensible default ceiling
    if args.semantic_cache:
        spec.pool.semantic_cache = True
    if args.sim_threshold is not None:
        spec.pool.semantic_cache = True
        spec.pool.sim_threshold = args.sim_threshold
    _apply_generation_flags("serve online", spec, args)
    _apply_robust_flags("serve online", spec, args)
    if spec.pool.kind == "simulated" and spec.pool.task not in BENCHMARKS:
        raise SystemExit(f"serve online: unknown task {spec.pool.task!r}; "
                         f"known: {sorted(BENCHMARKS)}")
    try:
        get_policy(spec.policy.name)
    except UnknownPolicyError:
        raise SystemExit(f"serve online: unknown policy {spec.policy.name!r}; "
                         f"known: {list_policies()}")

    gw = Gateway.from_spec(spec, device=args.device)
    print(f"fitting RoBatch on {spec.pool.task}/{spec.pool.family} "
          f"({spec.pool.n_train} train, coreset {spec.coreset_size})...")
    gw.fit()
    rb = gw.robatch

    test = gw.wl.subset_indices("test")
    base = float(rb.cost_model.state_cost(0, rb.calibrations[0].b_effect, test).mean())
    rate = args.qps * base * args.budget_x
    autoscale = spec.pool.autoscale_policy() if args.autoscale else None
    cfg = OnlineConfig(budget_per_s=rate, window_s=args.window,
                       realtime=args.realtime, autoscale=autoscale)
    rng = np.random.default_rng(spec.seed)
    arrivals = poisson_arrivals(rng, args.qps, args.duration, test,
                                repeat_frac=args.repeat_frac)
    mode = "live wall-clock" if args.realtime else "virtual-clock"
    print(f"streaming {len(arrivals)} arrivals at {args.qps} qps ({mode}) "
          f"through policy={spec.policy.name}, window {args.window}s, "
          f"budget ${rate:.6f}/s...")
    chaos = None
    if args.chaos is not None:
        from repro_torch.serving.fault import ChaosMember

        # latency noise everywhere; a short (sub-breaker-threshold) error
        # burst on the most expensive member so the degraded path exercises
        # reroutes while every breaker ends the run CLOSED
        last = len(gw.pool) - 1
        chaos = [ChaosMember(m, seed=args.chaos + k, latency_noise_s=0.002,
                             fail_from=1 if k == last else 10**9,
                             fail_until=3 if k == last else 10**9)
                 for k, m in enumerate(gw.pool)]
    t_wall = time.monotonic()
    stats = gw.serve(arrivals, cfg, live=args.realtime, pool=chaos)
    wall = time.monotonic() - t_wall
    srv = gw.server

    print(stats.summary())
    if args.realtime:
        late = [w.late_s for w in stats.windows]
        print(f"realtime: {wall:.2f}s wall for a {args.duration:.0f}s stream · "
              f"{len(late)} windows · max window lateness "
              f"{max(late, default=0.0) * 1e3:.1f}ms")
        if getattr(srv, "pacer_leaked", False):
            print("serve online: WARNING arrival pacer thread leaked past "
                  "shutdown join", file=sys.stderr)
    by_model = {}
    for r in srv.completed:
        if r.model is not None and not r.cache_hit:
            key = (srv.pool[r.model].name, r.batch)
            by_model[key] = by_model.get(key, 0) + 1
    print("dispatch mix (model, batch) -> queries:")
    for key in sorted(by_model, key=lambda t: (t[0], t[1] or 0)):
        print(f"  {key[0]:12s} b={key[1]}: {by_model[key]}")
    deferred = sum(w.n_deferred for w in stats.windows)
    print(f"policy={spec.policy.name} windows={len(stats.windows)} "
          f"deferred={deferred} shed={sum(w.n_shed for w in stats.windows)} "
          f"cache_entries={len(srv.cache)}")
    if srv.semcache is not None:
        sc = srv.semcache.stats()
        print(f"semcache: hits={sc['hits']} misses={sc['misses']} "
              f"entries={sc['entries']} bytes={sc['bytes']} "
              f"threshold={srv.semcache.cfg.sim_threshold} "
              f"utility_loss={sc['utility_loss']:.4f}")
    if chaos is not None:
        closed = all(br.state.value == "closed" for br in srv.breakers)
        print(f"chaos: seed={args.chaos} calls={sum(c.n_calls for c in chaos)} "
              f"faults={sum(c.n_faults for c in chaos)} "
              f"hangs={sum(c.n_hangs for c in chaos)} breakers_closed={closed}")
    if srv.autoscaler is not None:
        print(srv.autoscaler.summary())
        for e in srv.autoscaler.events:
            print(f"  t={e.t:7.2f}s {e.member}: {e.from_n} -> {e.to_n} ({e.reason})")


def http_main(argv):
    ap = argparse.ArgumentParser(prog="serve http")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="bind port (0 = ephemeral; the bound port is printed "
                         "on the 'listening on' line)")
    ap.add_argument("--policy", default=None,
                    help="registered policy name (repro_torch.api.list_policies())")
    ap.add_argument("--spec", default=None,
                    help="RunSpec JSON — a file path or an inline JSON string")
    ap.add_argument("--task", default=None, help="workload benchmark name")
    ap.add_argument("--family", default=None, help="simulated pool family")
    ap.add_argument("--qps", type=float, default=40.0,
                    help="assumed offered load for budget sizing")
    ap.add_argument("--window", type=float, default=0.1, help="admission window (s)")
    ap.add_argument("--budget-x", type=float, default=3.0,
                    help="budget rate = qps × cheapest-state cost × this factor")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engines per pool member (ReplicaSet when > 1)")
    ap.add_argument("--autoscale", action="store_true",
                    help="backlog-driven replica autoscaling between "
                         "--min-replicas and --max-replicas")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscale floor (default 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling (default 4 with --autoscale)")
    ap.add_argument("--semantic-cache", action="store_true",
                    help="embedding-space near-duplicate response cache "
                         "(repro_torch.serving.semcache; see docs/caching.md)")
    ap.add_argument("--sim-threshold", type=float, default=None,
                    help="semantic-cache cosine hit threshold (default 0.92)")
    _add_generation_flags(ap)
    _add_robust_flags(ap)
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="serve for N wall seconds then exit (0 = until "
                         "SIGINT/SIGTERM)")
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--coreset", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the router, the semantic cache and a "
                         "tiny pool's models: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import signal
    import threading

    from repro_torch.api import Gateway, UnknownPolicyError, get_policy, list_policies
    from repro_torch.data import BENCHMARKS
    from repro_torch.serving.online import OnlineConfig

    if args.qps <= 0:
        raise SystemExit("serve http: --qps must be positive")
    spec = _online_spec(args)
    if args.replicas is not None:
        spec.pool.replicas = args.replicas
    if args.min_replicas is not None:
        spec.pool.min_replicas = args.min_replicas
    if args.max_replicas is not None:
        spec.pool.max_replicas = args.max_replicas
    if args.autoscale and spec.pool.max_replicas <= 0:
        spec.pool.max_replicas = 4
    if args.semantic_cache:
        spec.pool.semantic_cache = True
    if args.sim_threshold is not None:
        spec.pool.semantic_cache = True
        spec.pool.sim_threshold = args.sim_threshold
    _apply_generation_flags("serve http", spec, args)
    _apply_robust_flags("serve http", spec, args)
    if spec.pool.kind == "simulated" and spec.pool.task not in BENCHMARKS:
        raise SystemExit(f"serve http: unknown task {spec.pool.task!r}; "
                         f"known: {sorted(BENCHMARKS)}")
    try:
        get_policy(spec.policy.name)
    except UnknownPolicyError:
        raise SystemExit(f"serve http: unknown policy {spec.policy.name!r}; "
                         f"known: {list_policies()}")

    gw = Gateway.from_spec(spec, device=args.device)
    print(f"fitting RoBatch on {spec.pool.task}/{spec.pool.family} "
          f"({spec.pool.n_train} train, coreset {spec.coreset_size})...",
          flush=True)
    gw.fit()
    rb = gw.robatch

    test = gw.wl.subset_indices("test")
    base = float(rb.cost_model.state_cost(0, rb.calibrations[0].b_effect, test).mean())
    rate = args.qps * base * args.budget_x
    autoscale = spec.pool.autoscale_policy() if args.autoscale else None
    cfg = OnlineConfig(budget_per_s=rate, window_s=args.window,
                       realtime=True, autoscale=autoscale)
    fe = gw.serve_http(cfg, host=args.host, port=args.port)
    print(f"serve http: listening on http://{args.host}:{fe.port} "
          f"(policy={spec.policy.name}, {len(gw.pool)} members, "
          f"window {args.window}s, budget ${rate:.6f}/s)", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    t0 = time.monotonic()
    while not stop.is_set():
        stop.wait(0.25)
        if args.max_seconds and time.monotonic() - t0 >= args.max_seconds:
            break
    fe.stop()
    srv = gw.server
    if fe.threads_leaked:
        print(f"serve http: shutdown LEAKED threads {fe.threads_leaked} — "
              f"{fe.n_http_requests} http requests, "
              f"{len(srv.completed)} completed", flush=True)
    else:
        print(f"serve http: shutdown clean — {fe.n_http_requests} http "
              f"requests, {len(srv.completed)} completed, "
              f"{len(srv.windows)} windows, "
              f"${srv.bucket.total_spent:.6f} spent", flush=True)
    if srv.semcache is not None:
        sc = srv.semcache.stats()
        print(f"semcache: hits={sc['hits']} misses={sc['misses']} "
              f"entries={sc['entries']} bytes={sc['bytes']}", flush=True)
    if srv.windows:
        print(f"  last window: {srv.windows[-1].summary()}", flush=True)


def main():
    argv = sys.argv[1:]
    if argv and argv[0] in ("engine", "online", "http"):
        mode, rest = argv[0], argv[1:]
    else:
        mode, rest = "engine", argv     # legacy: bare flags mean engine mode
    {"online": online_main, "http": http_main}.get(mode, engine_main)(rest)


if __name__ == "__main__":
    main()
