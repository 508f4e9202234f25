#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: the five CUDA kernel sources compiled by nvcc from
   ``src/repro_torch/csrc``, one nvcc per source, all started together;
   ptxas's report per kernel, and no spill in any WKV6 kernel;
   ``cuobjdump -sass`` of the flash library must show HGMMA (Hopper's
   tensor-core product) in the bf16 kernel at every head width.
3. Kernels against their plain PyTorch versions on the card: flash prefill
   at Qwen1.5-0.5B's heads (B=8, S in {128, 512}, bf16 and fp32), at ragged
   GQA/window shapes (D=32 and 64 with windows, D=16 under MQA), at S=1,
   at head widths 128 and 256 (MQA and GQA, G=3 that does not divide the
   block, ragged S, a window shorter than S), and at RecurrentGemma-9B's
   prefill shape (B=4, S=3072, H=16 on Hk=1, D=256, window 2048), every
   case in bf16 (the tensor-core kernel) and most in fp32 (the CUDA-core
   kernels) too; paged decode at B=8, page 16 with shared pages,
   a forked page, sentinel columns and one all-sentinel (retired) row, at
   G=1 and under GQA (G in {2, 4, 8}) and MQA (G=16);
   contiguous decode at B=8, H=Hk=16, D=64 with ragged lengths (0 and Smax
   included) on a horizon view of a longer cache, a GQA case, and G=16 at
   head widths 128 and 256 (a 2,048-slot ring among them); both D <= 64
   decode kernels at their design's edges, bf16 and fp32, D=64 at
   G in {1, 2, 4, 8, 16}, D=32 at G=3 and D=16: lengths 0, 1 and page-1,
   warps left empty, each warp-range and sub-tile boundary ±1, exactly the
   cache's capacity and past it, a retired row and a row whose table has a
   hole of sentinel pages under two warps' ranges; WKV6 at H=40, D=64, T in
   {1, 31, 32, 33, 37, 512} (the step, a chunk ± 1 and a short last chunk),
   bf16 and fp32, with a carried state and decays from RWKV6's own range,
   U(1e-12, 1) with a sixteenth at 1e-12, and exp(−exp(U(−6, 3.32))) (as
   many near 1 as near 1e-12, mixed within a chunk), at B=4 and at B·H = 5
   (fewer chunk blocks than SMs, so the chain across chunks runs with no
   other work beside it), and at D=16 and 32; the fp32 ones also held
   against the token-by-token oracle (the plain version's own distance from
   it printed beside); the RG-LRU scan at
   W=4096, T in {1, 37, 3072}, bf16 and fp32, with a carried state and
   log-gates mild, strong (down to −20) and within 1e-6 of 0, the fp32 ones
   also held against the token-by-token oracle.
4. Four main paths, each driven with every launch count set to 0 just
   before it and read just after; on each, every kernel it runs must have
   launched and no plain version may see a CUDA tensor:
   a. paged serving: full-width Qwen1.5-0.5B in bf16, random weights from
      the port's seeded ``Model.init``, 16 batch-prompted requests through
      ``ServingEngine(paged=True)`` (flash prefill, paged decode);
   b. contiguous serving: the same model and requests through
      ``ServingEngine(paged=False)`` (flash prefill, contiguous decode);
   c. full-width RWKV6-3B in bf16, random weights: ``Model.prefill`` of 4
      prompts of 512 token ids, then 32 greedy ``decode_step``s (WKV6 at
      every layer of every step, at least 32 × 33 launches);
   d. full-width RecurrentGemma-9B in bf16 (38 layers, 10.445 B
      parameters), random weights: ``Model.prefill`` of 4 prompts of 3,072
      token ids into caches of max_len 4,096 (2,048-slot rings), then 32
      greedy ``decode_step``s that write into the wrapped rings: exactly
      26 × 33 RG-LRU, 12 flash and 12 × 32 decode-attention launches.
   Paths c and d time prefill and the decode steps apart, then trace 8
   more decode steps with torch.profiler for the card's busy time a step.
   Every bf16 flash, decode and paged case of phase 3 and the flash,
   paged, decode and D=256 main-path entries are held row by row as well:
   the error of each output row over the row's largest plain value.  Each
   kernel is then timed, and held against its plain version, on inputs
   recorded from its path (the shapes the main path gives it): CUDA-event
   times after a writing flush, then, after every event timing of the run,
   each kernel's CUPTI device time a call (summed over the call's kernels)
   after a reading flush.
5. Parity in fp32, kernels against plain versions: both serving paths
   (prefill logits within 1e-3, identical greedy streams), RWKV6-3B and
   RecurrentGemma-9B at full depth (prefill logits within 1e-3, identical
   greedy streams over 32 steps).

The line before the last is a JSON object with one entry per kernel (time,
CUPTI time, launches, bound, plain and library times); the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke_results.json``.  Needs a CUDA device and the
repository's ``src/`` beside this file.
"""
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # as tests/test_kernels.py
WKV_ORACLE_TOL = 2e-4          # chunked vs token-by-token fp32, as tests/test_kernels.py
RGLRU_ORACLE_TOL = 1e-5        # kernel vs token-by-token fp32, as tests/test_kernels.py
LOGIT_TOL = 1e-3
SEED = 0
DEVICE = "cuda:0"
DECODE_WARPS = 8               # warps a block of the D <= 64 decode kernels (csrc/decode_body.cuh)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def row_rel_err(got, want):
    """Max over output rows (the last axis) of max|got − want| over the row's
    max|want|, a zero row taken as 1e-6: each row is held on its own scale,
    so rows that average thousands of values, far below one, are held as
    tightly as the rest."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp(min=1e-6)).max().item()


def decode_sub_tile(dtype, D, G):
    """Positions a warp of the D <= 64 decode kernels loads at once
    (``csrc/decode_body.cuh``): the rows one load instruction covers (32
    lanes over D / VEC lanes a row, VEC elements in 16 bytes) times the loads
    in flight a lane (8 when a block takes at most 2 query heads, else 4)."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return (8 if G <= 2 else 4) * 32 // (D // vec)


def timed_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each after the L2
    cache is evicted by writing ``flush`` (larger than the 50 MB L2), so every
    launch reads its inputs from device memory as the decode loop does."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def device_ms(fn, kernel_substr, iters=50, before=None):
    """CUPTI device time of one call of ``fn``: the self device time of every
    kernel whose name holds ``kernel_substr``, summed over ``iters`` calls
    (each after ``before()``, an L2 flush, when it is given) and divided by
    ``iters``, so a call that runs several kernels counts them all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel_substr in e.key]
    total = sum(e.self_device_time_total for e in rows)
    return None if not rows else total / iters / 1e3


def bound_ms(n_bytes, n_flops, dtype):
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def flash_work(q, k, window):
    """Bytes (q, k, v read once, out written once) and FLOPs (4·D per
    visible causal pair) of one flash call."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    i = np.arange(S)
    pairs = int(np.minimum(i + 1, window).sum() if window else (i + 1).sum())
    n_bytes = q.element_size() * (2 * B * S * H * D + 2 * B * S * Hk * D)
    return n_bytes, 4 * D * pairs * B * H


def paged_work(q, k_pool, table, lengths):
    """Bytes and FLOPs one paged call needs for this data: each distinct
    mapped K/V position below a row's length read once (a shared page once),
    q read and out written once, plus the table and lengths; 4·D FLOPs per
    (query head, visible position)."""
    B, _, H, D = q.shape
    P, ps, Hk, _ = k_pool.shape
    tab, lens = table.cpu().numpy(), lengths.cpu().numpy()
    rows, n_visible = set(), 0
    for b in range(B):
        for pos in range(min(int(lens[b]), tab.shape[1] * ps)):
            page = int(tab[b, pos // ps])
            if page < P:
                rows.add(page * ps + pos % ps)
                n_visible += 1
    n_bytes = (q.element_size() * (2 * B * H * D + 2 * len(rows) * Hk * D)
               + 4 * (table.numel() + lengths.numel()))
    return n_bytes, 4 * D * H * n_visible


def decode_work(q, k, lengths):
    """Bytes and FLOPs one contiguous decode call needs for this data: each
    row's K/V below its length read once, q read and out written once, plus
    the lengths; 4·D FLOPs per (query head, visible position)."""
    B, _, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    n_visible = int(lengths.clamp(max=S).sum())
    n_bytes = q.element_size() * (2 * B * H * D + 2 * n_visible * Hk * D) + 4 * B
    return n_bytes, 4 * D * H * n_visible


def wkv6_work(r, state):
    """Bytes and FLOPs one WKV6 call needs: r, k, v read and out written in
    the model dtype, w read in fp32, u read, the fp32 state read (unless it
    starts at zero, ``state`` None) and written; ~5·D² FLOPs per token and
    head (r·S, the bonus term and S ← w⊙S + kᵀv), done in fp32."""
    B, T, H, D = r.shape
    e = r.element_size()
    n_state = B * H * D * D * (1 if state is None else 2)
    n_bytes = 4 * B * T * H * D * e + 4 * B * T * H * D + H * D * e + 4 * n_state
    return n_bytes, 5 * D * D * B * T * H


def rglru_work(x, state):
    """Bytes and operations one RG-LRU call needs: x read and h written in the
    model dtype, a_log read in fp32, the fp32 state read (unless it starts at
    zero, ``state`` None) and written; 8 operations per token and channel
    (two exp, a sqrt, a max, a subtraction and the three of the update),
    each counted as one fp32 operation."""
    B, T, W = x.shape
    n_state = B * W * (1 if state is None else 2)
    return B * T * W * (2 * x.element_size() + 4) + 4 * n_state, 8 * B * T * W


def horizon_view(t, max_len):
    """``t`` (B, S, ...) copied to the start of a (B, max_len, ...) buffer and
    returned as the view ``buf[:, :S]``: the strided layout the contiguous
    engine hands the decode kernel."""
    buf = torch.zeros((t.shape[0], max_len, *t.shape[2:]), dtype=t.dtype, device=t.device)
    buf[:, :t.shape[1]] = t
    return buf[:, :t.shape[1]]


def serving_requests():
    """The serving workload: 16 batch prompts of 6 arithmetic queries behind
    one shared preamble (about 185 tokens each), 64 new tokens each; batch 1
    repeats batch 0, so their pages are shared whole and the first decode
    write forks one."""
    from repro_torch.serving.batcher import BatchPromptFormatter
    from repro_torch.serving.engine import Request

    fmt = BatchPromptFormatter("You are a careful assistant. Answer each of the following "
                               "arithmetic questions with one number, in order, separated "
                               "by semicolons.")
    rng = np.random.default_rng(SEED)
    batches = [[f"{rng.integers(0, 99)}+{rng.integers(0, 99)}" for _ in range(6)]
               for _ in range(16)]
    batches[1] = list(batches[0])
    return [Request(rid=i, tokens=fmt.format(qs), max_new=64) for i, qs in enumerate(batches)]


SERVE_MAX_LEN = 1024


def serving_engine(model, device, paged=True):
    """The engine the serving phases run: 8 slots, max_len 1024, K = 8, and
    (paged) page 16."""
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(model, max_slots=8, max_len=SERVE_MAX_LEN, decode_block=8,
                         paged=paged, page_size=16, device=device)


def random_prompts(vocab, B, T, seed):
    """B rows of T token ids drawn from a numpy seed over the vocab."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, T)).astype(np.int32))


def greedy(model, tokens, steps=32, **prefill_kw):
    """Prefill ``tokens`` and take ``steps`` greedy ``decode_step``s on the
    model's own cache.  Returns (prefill logits, (B, steps + 1) token ids,
    prefill seconds, decode seconds): host clock, each span ending in a
    synchronize.  The tokens stay on the card and the decode logits'
    finiteness is checked once after the loop, so no step waits on the
    host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, **prefill_kw)
    first = logits
    out = [logits[:, 0].argmax(dim=-1).to(torch.int32)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finite = torch.ones((), dtype=torch.bool, device=logits.device)
    for _ in range(steps):
        logits = model.decode_step(out[-1][:, None], cache)
        finite &= torch.isfinite(logits).all()
        out.append(logits[:, 0].argmax(dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    check(bool(finite), f"{model.cfg.name}: decode logits are not finite")
    return first, torch.stack(out, dim=1).cpu(), t1 - t0, decode_s


def trace_decode(label, model, tokens, step_s, steps=8, **prefill_kw):
    """Profile ``steps`` greedy decode steps after a prefill of ``tokens``:
    the card's busy time a step from torch.profiler's CUDA activity (the self
    device time of every kernel and copy on the card, summed; None when the
    trace holds no device time) beside ``step_s``, the host clock's step
    time of the untraced run, and the ten device entries that take most."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = model.prefill(tokens, **prefill_kw)
    tok = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = model.decode_step(tok, cache)[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3 / steps)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows) or None
    step_ms = 1e3 * step_s
    busy = None if device_ms is None else device_ms / step_ms
    print(f"[{label}] decode trace: device busy "
          + ("not measured (no device time in the trace)" if device_ms is None else
             f"{device_ms:.3f} ms a step of {step_ms:.3f} ms ({100 * busy:.1f}%)"))
    for name, ms in rows[:10]:
        print(f"[{label}]   {ms:.4f} ms a step: {name}")
    return dict(device_ms_per_step=device_ms, step_ms=step_ms, busy_share=busy,
                top=rows[:10])


@contextlib.contextmanager
def recording(module, name, keep):
    """Replace ``module.name`` by a wrapper that clones the arguments of the
    calls whose index is in ``keep`` into ``calls`` and then calls through."""
    orig = getattr(module, name)
    calls = {}
    count = [0]

    def wrapper(*args, **kwargs):
        if count[0] in keep:
            calls[count[0]] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                               dict(kwargs))
        count[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.config import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import rwkv6_scan as wkv6_mod
    from repro_torch.models.transformer import Model

    # name -> (module, kernel wrapper, plain version); ops.<name> dispatches
    kern = {"flash_attention": (flash_mod, "flash_attention_cuda", "flash_attention_plain"),
            "paged_attention": (paged_mod, "paged_attention_cuda", "paged_attention_plain"),
            "decode_attention": (decode_mod, "decode_attention_cuda", "decode_attention_plain"),
            "wkv6": (wkv6_mod, "wkv6_cuda", "wkv6_plain"),
            "rglru_scan": (rglru_mod, "rglru_cuda", "rglru_plain")}
    kernel = {n: getattr(m, c) for n, (m, c, _) in kern.items()}
    plain = {n: getattr(m, p) for n, (m, _, p) in kern.items()}
    flash_kernel, flash_plain = kernel["flash_attention"], plain["flash_attention"]
    paged_kernel, paged_plain = kernel["paged_attention"], plain["paged_attention"]
    decode_kernel, decode_plain = kernel["decode_attention"], plain["decode_attention"]
    wkv6_kernel, wkv6_plain = kernel["wkv6"], plain["wkv6"]
    rglru_kernel, rglru_plain = kernel["rglru_scan"], plain["rglru_scan"]
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False        # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    results = {"cases": []}

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    results["nvidia_smi"] = smi[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in took.items())}; "
          f"wall {build_s:.1f}s")
    for name in build.SOURCES:
        log = Path(f"{build.library_path(name)}.log")
        if log.exists():
            entry = ""
            for line in log.read_text().splitlines():
                m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)",
                              line)
                if m:
                    entry = m[1]
                elif "Used" in line or "spill" in line:
                    line = line.replace("ptxas info    : ", "").strip()
                    print(f"[build] {name}: {entry}: {line}")
                    results.setdefault("ptxas", []).append(f"{entry}: {line}")
                    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                    check(name != "rwkv6_scan" or spill is None or spill[1] == spill[2] == "0",
                          f"ptxas spills in {entry}: {line}")
    results["build_s"] = build_s
    sass = subprocess.run([str(Path(build.find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(build.library_path("flash_attention"))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] += 1
    tc_hgmma = {int(re.search(r"flash_tc_kernelILi(\d+)E", f)[1]): n
                for f, n in hgmma.items() if "flash_tc_kernel" in f}
    print(f"[build] flash_attention SASS: HGMMA instructions in flash_tc_kernel by head width "
          f"{dict(sorted(tc_hgmma.items()))}; in the fp32 kernels "
          f"{sum(n for f, n in hgmma.items() if 'flash_tc_kernel' not in f)}")
    check(sorted(tc_hgmma) == sorted(flash_mod.HEAD_DIMS) and all(tc_hgmma.values()),
          f"flash_tc_kernel lacks HGMMA at some head width: {tc_hgmma}")
    results["flash_tc_hgmma"] = tc_hgmma
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    # ---- 3. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_case(label, B, S, H, Hk, D, dtype, window=None):
        q, k, v = randn(B, S, H, D, dtype=dtype), randn(B, S, Hk, D, dtype=dtype), \
            randn(B, S, Hk, D, dtype=dtype)
        got = flash_kernel(q, k, v, window=window)
        want = flash_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"flash {label}: max abs err {err:.3g} > {TOL[dtype]}")
        rel = row_rel_err(got, want)
        check(dtype != torch.bfloat16 or rel <= TOL[dtype],
              f"flash {label}: row-relative err {rel:.3g} > {TOL[dtype]}")
        ms = timed_ms(lambda: flash_kernel(q, k, v, window=window), 20, flush)
        plain_ms = timed_ms(lambda: flash_plain(q, k, v, window=window), 5, flush)
        print(f"[kernels] flash {label} B={B} S={S} H={H} Hk={Hk} D={D} {str(dtype)[6:]} "
              f"window={window}: max|err| {err:.3g} (tol {TOL[dtype]}), row-relative "
              f"{rel:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["cases"].append(dict(kernel="flash_attention", label=label, B=B, S=S, H=H,
                                     Hk=Hk, D=D, dtype=str(dtype), window=window,
                                     max_abs_err=err, row_rel_err=rel, ms=ms,
                                     plain_ms=plain_ms))

    for S in (128, 512):
        for dtype in (torch.bfloat16, torch.float32):
            flash_case("qwen-heads", 8, S, 16, 16, 64, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case("ragged-gqa-window", 3, 77, 8, 2, 32, dtype, window=24)
    flash_case("ragged-mqa", 2, 45, 4, 1, 16, torch.bfloat16)
    flash_case("ragged-window-d64", 2, 200, 16, 16, 64, torch.bfloat16, window=64)
    for D in (64, 256):
        flash_case("single-position", 3, 1, 16, 1, D, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case("mqa-window-d256", 2, 301, 16, 1, 256, dtype, window=128)
        flash_case("gqa-d128", 2, 177, 8, 2, 128, dtype)
        flash_case("mha-window-d128", 1, 130, 4, 4, 128, dtype, window=100)
        flash_case("rgemma-prefill-d256", 4, 3072, 16, 1, 256, dtype, window=2048)
    flash_case("gqa3-window-d256", 1, 250, 12, 4, 256, torch.bfloat16, window=64)

    def paged_inputs(dtype, B=8, ps=16, H=16, Hk=16, D=64, max_len=512):
        """Pools and a table with a shared prefix of up to 8 pages (rows 0-3), a CoW
        fork (row 1's boundary page copies row 0's, then diverges), sentinel
        columns past every length, and a retired row 7 (all sentinels)."""
        rng = np.random.default_rng(SEED)
        n_cols = max_len // ps + 2
        lengths = rng.integers(max_len // 2, max_len + 1, B).astype(np.int32)
        lengths[1] = lengths[0]
        pages_of = [-(-int(n) // ps) for n in lengths]
        P = sum(pages_of) + 4
        free = list(rng.permutation(P))
        table = np.full((B, n_cols), P, np.int32)
        n_shared = min(8, *pages_of[:4])
        shared = [free.pop() for _ in range(n_shared)]
        for b in range(B - 1):
            own = [free.pop() for _ in range(pages_of[b] - (n_shared if b < 4 else 0))]
            table[b, :pages_of[b]] = (shared if b < 4 else []) + own
        lengths[B - 1] = 37                                 # stale length, no pages
        k_pool, v_pool = randn(P, ps, Hk, D, dtype=dtype), randn(P, ps, Hk, D, dtype=dtype)
        fork = int(table[1, pages_of[1] - 1])               # row 1's last page: a fork
        src = int(table[0, pages_of[0] - 1])
        k_pool[fork, :ps // 2] = k_pool[src, :ps // 2]
        v_pool[fork, :ps // 2] = v_pool[src, :ps // 2]
        q = randn(B, 1, H, D, dtype=dtype)
        return (q, k_pool, v_pool, torch.from_numpy(table).to(dev),
                torch.from_numpy(lengths).to(dev))

    def paged_case(label, args):
        q = args[0]
        got = paged_kernel(*args)
        want = paged_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[q.dtype], f"paged {label}: max abs err {err:.3g} > {TOL[q.dtype]}")
        rel = row_rel_err(got, want)
        check(q.dtype != torch.bfloat16 or rel <= TOL[q.dtype],
              f"paged {label}: row-relative err {rel:.3g} > {TOL[q.dtype]}")
        retired = args[3].eq(args[1].shape[0]).all(dim=1)
        check(bool(torch.isfinite(got).all()), f"paged {label}: non-finite output")
        check(bool(got[retired].eq(0).all()), f"paged {label}: retired row is not zero")
        ms = timed_ms(lambda: paged_kernel(*args), 50, flush)
        plain_ms = timed_ms(lambda: paged_plain(*args), 10, flush)
        print(f"[kernels] paged {label} q {tuple(q.shape)} pool {tuple(args[1].shape)} table "
              f"{tuple(args[3].shape)} {str(q.dtype)[6:]}: max|err| {err:.3g} "
              f"(tol {TOL[q.dtype]}), row-relative {rel:.3g}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        results["cases"].append(dict(kernel="paged_attention", label=label,
                                     q=list(q.shape), pool=list(args[1].shape),
                                     table=list(args[3].shape), dtype=str(q.dtype),
                                     max_abs_err=err, row_rel_err=rel, ms=ms,
                                     plain_ms=plain_ms))

    for dtype in (torch.bfloat16, torch.float32):
        paged_case("shared-fork-sentinel", paged_inputs(dtype))
        for G in (2, 4, 8, 16):          # GQA, and MQA at G=16
            paged_case(f"shared-fork-sentinel-g{G}", paged_inputs(dtype, Hk=16 // G))
    paged_case("ragged-gqa", paged_inputs(torch.float32, B=5, ps=8, H=8, Hk=2, D=32,
                                          max_len=100))

    def decode_case(label, B, S, H, Hk, D, dtype, max_len):
        """Ragged lengths with an empty row (zeros) and a full one, on a
        horizon view k[:, :S] of a (B, max_len) cache."""
        q = randn(B, 1, H, D, dtype=dtype)
        k = horizon_view(randn(B, S, Hk, D, dtype=dtype), max_len)
        v = horizon_view(randn(B, S, Hk, D, dtype=dtype), max_len)
        lengths = torch.from_numpy(np.random.default_rng(SEED + B).integers(
            1, S + 1, B).astype(np.int32)).to(dev)
        lengths[0], lengths[-1] = 0, S
        got = decode_kernel(q, k, v, lengths)
        want = decode_plain(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"decode {label}: max abs err {err:.3g} > {TOL[dtype]}")
        rel = row_rel_err(got, want)
        check(dtype != torch.bfloat16 or rel <= TOL[dtype],
              f"decode {label}: row-relative err {rel:.3g} > {TOL[dtype]}")
        check(bool(got[0].eq(0).all()), f"decode {label}: a length-0 row is not zero")
        ms = timed_ms(lambda: decode_kernel(q, k, v, lengths), 50, flush)
        plain_ms = timed_ms(lambda: decode_plain(q, k, v, lengths), 10, flush)
        print(f"[kernels] decode {label} B={B} S={S}/{max_len} H={H} Hk={Hk} D={D} "
              f"{str(dtype)[6:]}: max|err| {err:.3g} (tol {TOL[dtype]}), row-relative "
              f"{rel:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results["cases"].append(dict(kernel="decode_attention", label=label, B=B, S=S,
                                     max_len=max_len, H=H, Hk=Hk, D=D, dtype=str(dtype),
                                     max_abs_err=err, row_rel_err=rel, ms=ms,
                                     plain_ms=plain_ms))

    for dtype in (torch.bfloat16, torch.float32):
        decode_case("qwen-heads-horizon", 8, 512, 16, 16, 64, dtype, 1024)
    decode_case("ragged-gqa", 3, 77, 8, 2, 32, torch.float32, 100)
    decode_case("gqa-split", 2, 70, 20, 2, 64, torch.bfloat16, 80)
    for dtype in (torch.bfloat16, torch.float32):
        decode_case("mqa-ring-d256", 4, 2048, 16, 1, 256, dtype, 2048)
        decode_case("mqa-horizon-d128", 3, 300, 16, 1, 128, dtype, 400)
    decode_case("gqa-d256", 2, 90, 32, 2, 256, torch.float32, 100)

    def edge_lengths(dtype, D, G, ps, cap):
        """Lengths at the D <= 64 kernels' edges (``csrc/decode_body.cuh``):
        0, 1 and ps - 1; DECODE_WARPS ± 1 (warps left empty); one and two
        sub-tiles a warp ± 1, where the warps' ranges and the sub-tiles
        change; exactly ``cap`` (n_cols·ps or Smax) and past it."""
        w, sub = DECODE_WARPS, decode_sub_tile(dtype, D, G)
        lens = [0, 1, ps - 1, w - 1, w, w + 1]
        for n in (w * sub, 2 * w * sub):
            lens += [x for x in (n - 1, n, n + 1) if x < cap]
        return lens + [cap, cap + 5]

    def edge_check(kind, label, got, want, dtype, zero_rows):
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        check(err <= TOL[dtype] and (dtype != torch.bfloat16 or rel <= TOL[dtype]),
              f"{kind} {label}: max abs err {err:.3g}, row-relative {rel:.3g} > {TOL[dtype]}")
        check(bool(torch.isfinite(got).all()), f"{kind} {label}: non-finite output")
        check(bool(got[zero_rows].eq(0).all()), f"{kind} {label}: an empty row is not zero")
        print(f"[kernels] {kind} {label} q {tuple(got.shape)} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (tol {TOL[dtype]}), row-relative {rel:.3g}")
        results["cases"].append(dict(kernel=f"{kind}_attention", label=label,
                                     q=list(got.shape), dtype=str(dtype), max_abs_err=err,
                                     row_rel_err=rel))

    def decode_edges(dtype, D, G):
        """Every edge length of ``edge_lengths`` as one row each, on a
        horizon view of a longer cache; Smax leaves the two-sub-tile
        boundary inside it."""
        S = 2 * DECODE_WARPS * decode_sub_tile(dtype, D, G) + 8
        lens = edge_lengths(dtype, D, G, 16, S)
        B, Hk = len(lens), max(1, 16 // G)
        q = randn(B, 1, G * Hk, D, dtype=dtype)
        k = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        v = horizon_view(randn(B, S, Hk, D, dtype=dtype), S + 64)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        edge_check("decode", f"edges-d{D}-g{G} S={S} lengths {lens}",
                   decode_kernel(q, k, v, lengths), decode_plain(q, k, v, lengths), dtype,
                   lengths.eq(0))

    def paged_edges(dtype, D, G, ps=16):
        """The edge lengths over pages of their own, plus a retired row (all
        sentinels, length 100) and a row whose table has a hole of sentinel
        pages where warps 2 and 3 read (so those warps find nothing)."""
        sub = decode_sub_tile(dtype, D, G)
        n_cols = -(-(2 * DECODE_WARPS * sub + 8) // ps)
        lens = edge_lengths(dtype, D, G, ps, n_cols * ps) + [100, DECODE_WARPS * sub]
        B, Hk = len(lens), max(1, 16 // G)
        P = B * n_cols + 2
        pages = np.random.default_rng(SEED + D + G).permutation(P)
        table = np.full((B, n_cols), P, np.int32)
        for b, n in enumerate(lens):
            used = min(-(-n // ps), n_cols)
            table[b, :used] = pages[b * n_cols:b * n_cols + used]
        table[B - 2] = P                                   # retired
        table[B - 1, 2 * sub // ps:-(-4 * sub // ps)] = P  # hole under warps 2 and 3
        q = randn(B, 1, G * Hk, D, dtype=dtype)
        k_pool, v_pool = randn(P, ps, Hk, D, dtype=dtype), randn(P, ps, Hk, D, dtype=dtype)
        table, lengths = torch.from_numpy(table).to(dev), torch.tensor(lens, dtype=torch.int32,
                                                                       device=dev)
        args = (q, k_pool, v_pool, table, lengths)
        empty = lengths.eq(0) | table.eq(P).all(dim=1)
        edge_check("paged", f"edges-d{D}-g{G} lengths {lens}", paged_kernel(*args),
                   paged_plain(*args), dtype, empty)

    for dtype in (torch.bfloat16, torch.float32):
        for D, G in ((64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (32, 3), (16, 1)):
            decode_edges(dtype, D, G)
            paged_edges(dtype, D, G)

    def wkv6_inputs(B, T, H, D, dtype, decays="rwkv"):
        """r/k/v ~ N(0, 1), u ~ U(−0.5, 0.5), a carried state, and decays
        from RWKV6's own range exp(−exp(U(−0.5, 0.5))), or (``tiny``)
        U(1e-12, 1) with a sixteenth set to 1e-12, where a chunk's log-decay
        sums run to hundreds, or (``wide``) exp(−exp(U(−6, 3.32))), from
        0.998 down to 1e-12 with as many near 1 as near 1e-12, so that decays
        near 1 sit in a chunk beside sums of hundreds."""
        r, k, v = (randn(B, T, H, D, dtype=dtype) for _ in range(3))
        w_raw = torch.rand((B, T, H, D), generator=gen, device=dev)
        if decays == "rwkv":
            w = torch.exp(-torch.exp(w_raw - 0.5))
        elif decays == "wide":
            w = torch.exp(-torch.exp(-6.0 + 9.32 * w_raw))
        else:
            w = w_raw.clamp(1e-12, 1.0)
            w[torch.rand((B, T, H, D), generator=gen, device=dev) < 1 / 16] = 1e-12
        u = (torch.rand((H, D), generator=gen, device=dev) - 0.5).to(dtype)
        return r, k, v, w, u, 0.3 * randn(B, H, D, D, dtype=torch.float32)

    def scaled_err(got, want):
        """Max |got − want| and whether it is within TOL·(1 + |want|): the
        outputs run to tens, so the dtype's tolerance is taken relative
        above one, as ``assert_allclose(atol=rtol=TOL)`` takes it."""
        d = (got.float() - want.float()).abs()
        return d.max().item(), (d / (1 + want.float().abs())).max().item()

    def wkv6_case(B, T, H, D, dtype, decays="rwkv", timed=True):
        args = wkv6_inputs(B, T, H, D, dtype, decays)
        out, st = wkv6_kernel(*args)
        out_p, st_p = wkv6_plain(*args)
        torch.cuda.synchronize()
        err, rel = scaled_err(out, out_p)
        s_err, s_rel = scaled_err(st, st_p)
        tol = TOL[dtype]
        check(rel <= tol and s_rel <= TOL[torch.float32],
              f"wkv6 B={B} T={T} H={H} D={D} {decays} {dtype}: kernel vs plain {err:.3g} "
              f"(scaled {rel:.3g}), state {s_err:.3g} (scaled {s_rel:.3g})")
        line = dict(kernel="wkv6", B=B, T=T, H=H, D=D, dtype=str(dtype), decays=decays,
                    max_abs_err=err, scaled_err=rel, state_err=s_err,
                    out_max=out_p.float().abs().max().item())
        if dtype == torch.float32:
            # the plain version's own distance from the oracle beside the
            # kernel's: the chunked fp32 form's error, which grows as the
            # chunk's log-decay sums do
            out_r, st_r = ref.wkv6_ref(*args)
            _, o_rel = scaled_err(out, out_r)
            _, so_rel = scaled_err(st, st_r)
            _, po_rel = scaled_err(out_p, out_r)
            _, pso_rel = scaled_err(st_p, st_r)
            check(o_rel <= WKV_ORACLE_TOL and so_rel <= WKV_ORACLE_TOL,
                  f"wkv6 B={B} T={T} H={H} D={D} {decays}: kernel vs oracle {o_rel:.3g}, "
                  f"state {so_rel:.3g} (plain {po_rel:.3g}, {pso_rel:.3g})")
            line.update(oracle_err=o_rel, oracle_state_err=so_rel, plain_oracle_err=po_rel,
                        plain_oracle_state_err=pso_rel)
        if timed:
            line["ms"] = timed_ms(lambda: wkv6_kernel(*args), 20, flush)
            line["plain_ms"] = timed_ms(lambda: wkv6_plain(*args), 3, flush)
        print(f"[kernels] wkv6 B={B} T={T} H={H} D={D} {decays} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (scaled {rel:.3g}, tol {tol}), state {s_err:.3g} (scaled "
              f"{s_rel:.3g}), oracle {line.get('oracle_err', '-')} (plain "
              f"{line.get('plain_oracle_err', '-')})"
              + (f", kernel {line['ms']:.4f} ms, plain {line['plain_ms']:.4f} ms" if timed
                 else ""))
        results["cases"].append(line)

    for T in (1, 37, 512):
        for dtype in (torch.bfloat16, torch.float32):
            wkv6_case(4, T, 40, 64, dtype)
    wkv6_case(2, 45, 3, 16, torch.float32)
    # the design's edges: the step, a chunk ± 1 and a short last chunk, decays
    # down to 1e-12, and B·H = 5, where the 80 chunk blocks of T = 512 fill
    # fewer than the card's SMs and the chain across chunks runs alone
    for T in (1, 31, 32, 33, 37, 512):
        for dtype in (torch.bfloat16, torch.float32):
            if T in (31, 32, 33):
                wkv6_case(4, T, 40, 64, dtype, timed=False)
            for decays in ("tiny", "wide"):
                wkv6_case(4, T, 40, 64, dtype, decays, timed=False)
    for dtype in (torch.bfloat16, torch.float32):
        for decays in ("rwkv", "tiny", "wide"):
            wkv6_case(1, 512, 5, 64, dtype, decays, timed=False)
    for decays in ("tiny", "wide"):
        wkv6_case(2, 33, 3, 32, torch.float32, decays, timed=False)
    wkv6_case(2, 45, 3, 16, torch.float32, decays="wide", timed=False)

    def rglru_inputs(B, T, W, dtype, gates):
        """x ~ N(0, 1), a carried state ~ N(0, 1), and log-gates ``mild``
        −|N(0, 0.5)|, ``strong`` U(−20, 0) or ``near0`` U(−1e-6, 0), where
        1 − exp(2a) keeps only a few bits."""
        x = randn(B, T, W, dtype=dtype)
        u = torch.rand((B, T, W), generator=gen, device=dev)
        a_log = {"mild": lambda: -(0.5 * torch.randn((B, T, W), generator=gen,
                                                     device=dev)).abs(),
                 "strong": lambda: -20.0 * u, "near0": lambda: -1e-6 * u}[gates]()
        return x, a_log, randn(B, W, dtype=torch.float32)

    def rglru_case(B, T, W, dtype, gates):
        args = rglru_inputs(B, T, W, dtype, gates)
        h, st = rglru_kernel(*args)
        h_p, st_p = rglru_plain(*args)
        torch.cuda.synchronize()
        err, rel = scaled_err(h, h_p)
        s_err, s_rel = scaled_err(st, st_p)
        check(rel <= TOL[dtype] and s_rel <= TOL[torch.float32],
              f"rglru T={T} {gates} {dtype}: kernel vs plain {err:.3g} (scaled {rel:.3g}), "
              f"state {s_err:.3g} (scaled {s_rel:.3g})")
        line = dict(kernel="rglru_scan", B=B, T=T, W=W, gates=gates, dtype=str(dtype),
                    max_abs_err=err, scaled_err=rel, state_err=s_err)
        if dtype == torch.float32:
            h_r, st_r = ref.rglru_ref(*args)
            o_err, o_rel = scaled_err(h, h_r)
            so_err, so_rel = scaled_err(st, st_r)
            check(o_rel <= RGLRU_ORACLE_TOL and so_rel <= RGLRU_ORACLE_TOL,
                  f"rglru T={T} {gates}: kernel vs oracle {o_err:.3g}, state {so_err:.3g}")
            line.update(oracle_err=o_err, oracle_state_err=so_err)
        line["ms"] = timed_ms(lambda: rglru_kernel(*args), 20, flush)
        line["plain_ms"] = timed_ms(lambda: rglru_plain(*args), 3, flush)
        print(f"[kernels] rglru B={B} T={T} W={W} {gates} {str(dtype)[6:]}: max|err| "
              f"{err:.3g} (scaled {rel:.3g}, tol {TOL[dtype]}), state {s_err:.3g}, oracle "
              f"{line.get('oracle_err', '-')}, kernel {line['ms']:.4f} ms, plain "
              f"{line['plain_ms']:.4f} ms")
        results["cases"].append(line)

    for T in (1, 37, 3072):
        for dtype in (torch.bfloat16, torch.float32):
            for gates in ("mild", "strong", "near0"):
                rglru_case(4, T, 4096, dtype, gates)

    # ---- 4. the main paths -----------------------------------------------
    plain_on_cuda = {"n": 0}

    def guard(fn):
        def wrapper(x, *args, **kwargs):
            plain_on_cuda["n"] += x.is_cuda
            return fn(x, *args, **kwargs)
        return wrapper

    @contextlib.contextmanager
    def main_path(label, expect):
        """Launch counts to 0 before the path, read after; every kernel of
        ``expect`` must have launched and no plain version may see a CUDA
        tensor."""
        for fn in kernel.values():
            fn.launches = 0
        plain_on_cuda["n"] = 0
        for n, (m, _, p) in kern.items():
            setattr(m, p, guard(plain[n]))
        counts = {}
        try:
            torch.cuda.synchronize()
            yield counts
            torch.cuda.synchronize()
        finally:
            for n, (m, _, p) in kern.items():
                setattr(m, p, plain[n])
        counts.update({n: fn.launches for n, fn in kernel.items()})
        print(f"[{label}] launches {counts}; plain calls on CUDA tensors {plain_on_cuda['n']}")
        check(all(counts[n] > 0 for n in expect), f"{label}: a kernel never launched: {counts}")
        check(plain_on_cuda["n"] == 0, f"{label}: a plain version ran on CUDA tensors")
        results.setdefault("launches", {})[label] = dict(counts)

    cfg = get_arch("qwen1.5-0.5b")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {model.param_count() / 1e9:.3f} B parameters in "
          f"{str(model.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")
    n_per_dispatch = cfg.n_layers * 8

    def serve(label, paged, record):
        engine, reqs = serving_engine(model, dev, paged=paged), serving_requests()
        with main_path(label, ("flash_attention", record)) as counts, \
                recording(ops, "flash_attention", {0}) as flash_calls, \
                recording(ops, record, {3 * n_per_dispatch}) as decode_calls:
            t0 = time.perf_counter()
            engine.serve(reqs)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        n_done = sum(r.done for r in reqs)
        n_tok = sum(len(r.out_tokens) for r in reqs)
        occ = engine.kv_occupancy()
        print(f"[{label}] {n_done}/{len(reqs)} requests, {n_tok} tokens in {serve_s:.3f}s: "
              f"{n_tok / serve_s:.1f} tokens/s; prompts {min(len(r.tokens) for r in reqs)}-"
              f"{max(len(r.tokens) for r in reqs)} tokens; {engine.n_prefill_calls} prefills, "
              f"{engine.n_decode_calls} decode dispatches; kv peak "
              f"{occ['peak_kv_bytes'] / 2**20:.1f} MiB")
        check(n_done == len(reqs), f"{label}: served {n_done}/{len(reqs)} requests")
        check(all(len(r.out_tokens) >= 1 for r in reqs), f"{label}: a request produced no token")
        check(0 in flash_calls and decode_calls, f"{label}: main-path inputs were not recorded")
        results[label] = dict(requests=n_done, tokens=n_tok, seconds=serve_s,
                              tokens_per_s=n_tok / serve_s, launches=counts,
                              launches_per_request={k: v / n_done for k, v in counts.items()},
                              kv=occ, prefills=engine.n_prefill_calls,
                              decode_dispatches=engine.n_decode_calls)
        return occ, counts, flash_calls[0], next(iter(decode_calls.values()))

    occ, paged_counts, flash_call, paged_call = serve("paged", True, "paged_attention")
    check(occ["prefix_shares"] > 0 and occ["cow_forks"] > 0,
          "prefix sharing or copy-on-write never engaged")
    _, contig_counts, _, decode_call = serve("contiguous", False, "decode_attention")
    del model
    torch.cuda.empty_cache()

    rcfg = get_arch("rwkv6-3b")
    t0 = time.perf_counter()
    rmodel = Model(rcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"[rwkv6] {rcfg.name}: {rmodel.param_count() / 1e9:.3f} B parameters in "
          f"{str(rmodel.dtype)[6:]}, init {time.perf_counter() - t0:.1f}s")
    prompts = random_prompts(rcfg.vocab_size, 4, 512, SEED + 1).to(dev)
    n_steps = 32
    with main_path("rwkv6", ("wkv6",)) as rwkv_counts, \
            recording(ops, "wkv6", {0, rcfg.n_layers}) as wkv6_calls:
        r_logits, r_streams, r_prefill_s, r_decode_s = greedy(rmodel, prompts, n_steps)
        rwkv_s = r_prefill_s + r_decode_s
    check(rwkv_counts["wkv6"] >= rcfg.n_layers * (n_steps + 1),
          f"rwkv6: {rwkv_counts['wkv6']} WKV6 launches < {rcfg.n_layers} x {n_steps + 1}")
    want_shape = (prompts.shape[0], 1, rmodel.vocab_padded)
    check(tuple(r_logits.shape) == want_shape and bool(torch.isfinite(r_logits).all()),
          f"rwkv6: prefill logits {tuple(r_logits.shape)} not finite of {want_shape}")
    check(bool(((r_streams >= 0) & (r_streams < rcfg.vocab_size)).all()),
          "rwkv6: a token id out of the vocab")
    print(f"[rwkv6] prefill 4x{prompts.shape[1]} in {r_prefill_s:.3f}s, {n_steps} greedy "
          f"steps in {r_decode_s:.3f}s ({1e3 * r_decode_s / n_steps:.1f} ms a step); "
          f"{rwkv_s:.3f}s in all")
    r_trace = trace_decode("rwkv6", rmodel, prompts, r_decode_s / n_steps)
    results["rwkv6"] = dict(seconds=rwkv_s, prefill_s=r_prefill_s, decode_s=r_decode_s,
                            launches=rwkv_counts, steps=n_steps,
                            prompt_shape=list(prompts.shape), decode_trace=r_trace)
    del rmodel
    torch.cuda.empty_cache()

    gcfg = get_arch("recurrentgemma-9b")
    kinds = gcfg.layer_kinds()
    n_rec, n_local = kinds.count("rglru"), kinds.count("local")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gmodel = Model(gcfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    g_params = gmodel.param_count()
    print(f"[rgemma] {gcfg.name}: {g_params / 1e9:.3f} B parameters in "
          f"{str(gmodel.dtype)[6:]} (the config's own estimate: "
          f"{gcfg.param_count() / 1e9:.3f} B), init {time.perf_counter() - t0:.1f}s")
    g_prompts = random_prompts(gcfg.vocab_size, 4, 3072, SEED + 2).to(dev)
    g_max_len = 4096
    with main_path("recurrentgemma", ("rglru_scan", "flash_attention", "decode_attention")) \
            as g_counts, \
            recording(ops, "rglru_scan", {0, n_rec}) as rglru_calls, \
            recording(ops, "flash_attention", {0}) as g_flash_calls, \
            recording(ops, "decode_attention", {0}) as g_decode_calls:
        g_logits, g_streams, g_prefill_s, g_decode_s = greedy(gmodel, g_prompts, n_steps,
                                                              max_len=g_max_len)
    want_counts = {"rglru_scan": n_rec * (n_steps + 1), "flash_attention": n_local,
                   "decode_attention": n_local * n_steps}
    check(all(g_counts[n] == c for n, c in want_counts.items()),
          f"recurrentgemma: launches {g_counts}, expected {want_counts}")
    want_shape = (g_prompts.shape[0], 1, gmodel.vocab_padded)
    check(tuple(g_logits.shape) == want_shape and bool(torch.isfinite(g_logits).all()),
          f"recurrentgemma: prefill logits {tuple(g_logits.shape)} not finite of {want_shape}")
    check(bool(((g_streams >= 0) & (g_streams < gcfg.vocab_size)).all()),
          "recurrentgemma: a token id out of the vocab")
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[rgemma] prefill 4x{g_prompts.shape[1]} (max_len {g_max_len}, ring "
          f"{min(gcfg.window, g_max_len)}) in {g_prefill_s:.3f}s, {n_steps} greedy steps in "
          f"{g_decode_s:.3f}s ({1e3 * g_decode_s / n_steps:.1f} ms a step); peak memory "
          f"{g_peak:.1f} GiB")
    g_trace = trace_decode("rgemma", gmodel, g_prompts, g_decode_s / n_steps,
                           max_len=g_max_len)
    results["recurrentgemma"] = dict(params=g_params, config_param_estimate=gcfg.param_count(),
                                     prefill_s=g_prefill_s, decode_s=g_decode_s,
                                     launches=g_counts, steps=n_steps, max_len=g_max_len,
                                     prompt_shape=list(g_prompts.shape), peak_gib=g_peak,
                                     decode_trace=g_trace)
    del gmodel
    torch.cuda.empty_cache()

    # the kernels on the inputs the main paths gave them
    entries = []
    (fq, fk, fv), fkw = flash_call
    fkw = {"causal": fkw.get("causal", True), "window": fkw.get("window")}
    f_out, f_want = flash_kernel(fq, fk, fv, **fkw), flash_plain(fq, fk, fv, **fkw)
    f_err = (f_out.float() - f_want.float()).abs().max().item()
    f_rel = row_rel_err(f_out, f_want)
    check(f_err <= TOL[fq.dtype] and f_rel <= TOL[fq.dtype], f"flash on main-path inputs: max "
          f"abs err {f_err:.3g}, row-relative {f_rel:.3g} > {TOL[fq.dtype]}")
    f_max = f_want.float().abs().max().item()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_bound, f_by = bound_ms(*flash_work(fq, fk, fkw["window"]), fq.dtype)
    entries.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=paged_counts["flash_attention"], max_abs_err=f_err, atol=TOL[fq.dtype], rtol=0.0,
        row_rel_err=f_rel, out_max=f_max,
        ms=timed_ms(lambda: flash_kernel(fq, fk, fv, **fkw), 20, flush),
        plain_ms=timed_ms(lambda: flash_plain(fq, fk, fv, **fkw), 5, flush),
        bound_ms=f_bound, bound_by=f_by,
        library_ms=timed_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20, flush),
        shape=dict(q=list(fq.shape), k=list(fk.shape), dtype=str(fq.dtype))))
    pargs, _ = paged_call
    p_out, p_want = paged_kernel(*pargs), paged_plain(*pargs)
    p_err = (p_out.float() - p_want.float()).abs().max().item()
    p_rel = row_rel_err(p_out, p_want)
    check(p_err <= TOL[pargs[0].dtype] and p_rel <= TOL[pargs[0].dtype],
          f"paged on main-path inputs: max abs err {p_err:.3g}, row-relative {p_rel:.3g}")
    p_bound, p_by = bound_ms(*paged_work(pargs[0], pargs[1], pargs[3], pargs[4]),
                             pargs[0].dtype)
    entries.append(dict(
        name="paged_attention", route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:116",
        launches=paged_counts["paged_attention"], max_abs_err=p_err, atol=TOL[pargs[0].dtype],
        rtol=0.0, row_rel_err=p_rel, out_max=p_want.float().abs().max().item(),
        ms=timed_ms(lambda: paged_kernel(*pargs), 50, flush),
        plain_ms=timed_ms(lambda: paged_plain(*pargs), 10, flush),
        bound_ms=p_bound, bound_by=p_by, library_ms=None,
        shape=dict(q=list(pargs[0].shape), pool=list(pargs[1].shape),
                   table=list(pargs[3].shape), lengths=pargs[4].tolist(),
                   dtype=str(pargs[0].dtype))))
    (dq, dk, dv, dlen), _ = decode_call
    dk, dv = horizon_view(dk, SERVE_MAX_LEN), horizon_view(dv, SERVE_MAX_LEN)
    d_out, d_want = decode_kernel(dq, dk, dv, dlen), decode_plain(dq, dk, dv, dlen)
    d_err = (d_out.float() - d_want.float()).abs().max().item()
    d_rel = row_rel_err(d_out, d_want)
    check(d_err <= TOL[dq.dtype] and d_rel <= TOL[dq.dtype],
          f"decode on main-path inputs: max abs err {d_err:.3g}, row-relative {d_rel:.3g}")
    # the library yardstick: SDPA over (B, H, S, D) with the length mask
    G = dq.shape[2] // dk.shape[2]
    sq = dq.transpose(1, 2).contiguous()
    sk, sv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (dk, dv))
    smask = (torch.arange(dk.shape[1], device=dev)[None, :] < dlen[:, None])[:, None, None, :]
    d_bound, d_by = bound_ms(*decode_work(dq, dk, dlen), dq.dtype)
    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=contig_counts["decode_attention"], max_abs_err=d_err, atol=TOL[dq.dtype],
        rtol=0.0, row_rel_err=d_rel, out_max=d_want.float().abs().max().item(),
        ms=timed_ms(lambda: decode_kernel(dq, dk, dv, dlen), 50, flush),
        plain_ms=timed_ms(lambda: decode_plain(dq, dk, dv, dlen), 10, flush),
        bound_ms=d_bound, bound_by=d_by,
        library_ms=timed_ms(lambda: sdpa(sq, sk, sv, attn_mask=smask), 50, flush),
        shape=dict(q=list(dq.shape), k=list(dk.shape), k_stride=list(dk.stride()),
                   lengths=dlen.tolist(), dtype=str(dq.dtype))))
    wkv6_extra = {}
    for idx, label in ((rcfg.n_layers, "decode"), (0, "prefill")):
        wargs, _ = wkv6_calls[idx]
        w_out, w_st = wkv6_kernel(*wargs)
        w_out_p, w_st_p = wkv6_plain(*wargs)
        w_err, w_rel = scaled_err(w_out, w_out_p)
        w_serr, w_srel = scaled_err(w_st, w_st_p)
        check(w_rel <= TOL[wargs[0].dtype] and w_srel <= TOL[torch.float32],
              f"wkv6 on main-path {label} inputs: {w_err:.3g} (scaled {w_rel:.3g}), state "
              f"{w_serr:.3g}")
        w_bound, w_by = bound_ms(*wkv6_work(wargs[0], wargs[5]), torch.float32)
        wkv6_extra[label] = dict(
            max_abs_err=w_err, scaled_err=w_rel, state_err=w_serr, atol=TOL[wargs[0].dtype],
            rtol=TOL[wargs[0].dtype],
            ms=timed_ms(lambda: wkv6_kernel(*wargs), 20, flush),
            plain_ms=timed_ms(lambda: wkv6_plain(*wargs), 3 if label == "prefill" else 10,
                              flush),
            bound_ms=w_bound, bound_by=w_by,
            shape=dict(r=list(wargs[0].shape), dtype=str(wargs[0].dtype)))
    wp = wkv6_extra["prefill"]
    entries.append(dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:94", launches=rwkv_counts["wkv6"],
        max_abs_err=wp["max_abs_err"], atol=wp["atol"], rtol=wp["rtol"], ms=wp["ms"],
        plain_ms=wp["plain_ms"],
        bound_ms=wp["bound_ms"], bound_by=wp["bound_by"], library_ms=None,
        shape=wp["shape"], decode_step=wkv6_extra["decode"]))
    rglru_extra = {}
    for idx, label in ((n_rec, "decode"), (0, "prefill")):
        gargs, _ = rglru_calls[idx]
        g_out, g_st = rglru_kernel(*gargs)
        g_out_p, g_st_p = rglru_plain(*gargs)
        g_err, g_rel = scaled_err(g_out, g_out_p)
        g_serr, g_srel = scaled_err(g_st, g_st_p)
        check(g_rel <= TOL[gargs[0].dtype] and g_srel <= TOL[torch.float32],
              f"rglru on main-path {label} inputs: {g_err:.3g} (scaled {g_rel:.3g}), state "
              f"{g_serr:.3g}")
        g_bound, g_by = bound_ms(*rglru_work(gargs[0], gargs[2]), torch.float32)
        rglru_extra[label] = dict(
            max_abs_err=g_err, scaled_err=g_rel, state_err=g_serr, atol=TOL[gargs[0].dtype],
            rtol=TOL[gargs[0].dtype],
            ms=timed_ms(lambda: rglru_kernel(*gargs), 20, flush),
            plain_ms=timed_ms(lambda: rglru_plain(*gargs), 3 if label == "prefill" else 10,
                              flush),
            bound_ms=g_bound, bound_by=g_by,
            shape=dict(x=list(gargs[0].shape), dtype=str(gargs[0].dtype),
                       state=gargs[2] is not None))
    gp = rglru_extra["prefill"]
    entries.append(dict(
        name="rglru_scan", route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:69", launches=g_counts["rglru_scan"],
        max_abs_err=gp["max_abs_err"], atol=gp["atol"], rtol=gp["rtol"], ms=gp["ms"],
        plain_ms=gp["plain_ms"], bound_ms=gp["bound_ms"], bound_by=gp["bound_by"],
        library_ms=None, shape=gp["shape"], decode_step=rglru_extra["decode"]))
    (gq, gk, gv), gkw = g_flash_calls[0]
    gkw = {"causal": gkw.get("causal", True), "window": gkw.get("window")}
    check(gkw["window"] == gcfg.window, f"recurrentgemma flash saw window {gkw['window']}")
    gf_out, gf_want = flash_kernel(gq, gk, gv, **gkw), flash_plain(gq, gk, gv, **gkw)
    gf_err = (gf_out.float() - gf_want.float()).abs().max().item()
    gf_rel = row_rel_err(gf_out, gf_want)
    check(gf_rel <= TOL[gq.dtype], f"flash d256 on main-path inputs: max abs err {gf_err:.3g}, "
          f"row-relative {gf_rel:.3g} > {TOL[gq.dtype]}")
    gf_max = gf_want.float().abs().max().item()
    del gf_out, gf_want
    G = gq.shape[2] // gk.shape[2]
    gqt = gq.transpose(1, 2).contiguous()
    gkt, gvt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (gk, gv))
    pos = torch.arange(gq.shape[1], device=dev)
    win_mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - gkw["window"])
    gf_bound, gf_by = bound_ms(*flash_work(gq, gk, gkw["window"]), gq.dtype)
    entries.append(dict(
        name="flash_attention_d256", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:124",
        launches=g_counts["flash_attention"], max_abs_err=gf_err, atol=0.0,
        rtol=TOL[gq.dtype], scale="row", row_rel_err=gf_rel, out_max=gf_max,
        ms=timed_ms(lambda: flash_kernel(gq, gk, gv, **gkw), 10, flush),
        plain_ms=timed_ms(lambda: flash_plain(gq, gk, gv, **gkw), 3, flush),
        bound_ms=gf_bound, bound_by=gf_by,
        library_ms=timed_ms(lambda: sdpa(gqt, gkt, gvt, attn_mask=win_mask), 10, flush),
        shape=dict(q=list(gq.shape), k=list(gk.shape), window=gkw["window"],
                   dtype=str(gq.dtype))))
    del gqt, gkt, gvt
    (eq, ek, ev, elen), _ = g_decode_calls[0]
    ge_out, ge_want = decode_kernel(eq, ek, ev, elen), decode_plain(eq, ek, ev, elen)
    ge_err = (ge_out.float() - ge_want.float()).abs().max().item()
    ge_rel = row_rel_err(ge_out, ge_want)
    check(ge_rel <= TOL[eq.dtype], f"decode d256 on main-path inputs: max abs err "
          f"{ge_err:.3g}, row-relative {ge_rel:.3g} > {TOL[eq.dtype]}")
    ge_max = ge_want.float().abs().max().item()
    G = eq.shape[2] // ek.shape[2]
    eqt = eq.transpose(1, 2).contiguous()
    ekt, evt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() for x in (ek, ev))
    emask = (torch.arange(ek.shape[1], device=dev)[None, :] < elen[:, None])[:, None, None, :]
    ge_bound, ge_by = bound_ms(*decode_work(eq, ek, elen), eq.dtype)
    entries.append(dict(
        name="decode_attention_d256", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=g_counts["decode_attention"], max_abs_err=ge_err, atol=0.0,
        rtol=TOL[eq.dtype], scale="row", row_rel_err=ge_rel, out_max=ge_max,
        ms=timed_ms(lambda: decode_kernel(eq, ek, ev, elen), 50, flush),
        plain_ms=timed_ms(lambda: decode_plain(eq, ek, ev, elen), 10, flush),
        bound_ms=ge_bound, bound_by=ge_by,
        library_ms=timed_ms(lambda: sdpa(eqt, ekt, evt, attn_mask=emask), 50, flush),
        shape=dict(q=list(eq.shape), k=list(ek.shape), lengths=elen.tolist(),
                   dtype=str(eq.dtype))))
    # CUPTI device time a call, read after every event timing of the run (a
    # process that has run the profiler pays more host time a launch), each
    # call after a reading flush of the 128 MB buffer; the name fragment
    # takes in every kernel a call runs
    (wpa, _), (wda, _) = wkv6_calls[0], wkv6_calls[rcfg.n_layers]
    (gpa, _), (gda, _) = rglru_calls[0], rglru_calls[n_rec]
    cupti = {"flash_attention": (lambda: flash_kernel(fq, fk, fv, **fkw), "flash_", 50),
             "paged_attention": (lambda: paged_kernel(*pargs), "paged_decode_kernel", 50),
             "decode_attention": (lambda: decode_kernel(dq, dk, dv, dlen), "decode_", 50),
             "wkv6": (lambda: wkv6_kernel(*wpa), "wkv6_", 50),
             "rglru_scan": (lambda: rglru_kernel(*gpa), "rglru_", 50),
             "flash_attention_d256": (lambda: flash_kernel(gq, gk, gv, **gkw), "flash_", 20),
             "decode_attention_d256": (lambda: decode_kernel(eq, ek, ev, elen), "decode_", 50)}
    for e in entries:
        fn, frag, iters = cupti[e["name"]]
        e["cupti_ms"] = device_ms(fn, frag, iters, before=flush.max)
    wkv6_extra["decode"]["cupti_ms"] = device_ms(lambda: wkv6_kernel(*wda), "wkv6_", 50,
                                                 before=flush.max)
    rglru_extra["decode"]["cupti_ms"] = device_ms(lambda: rglru_kernel(*gda), "rglru_", 50,
                                                  before=flush.max)
    for e in entries:
        print(f"[main-path] {e['name']} {e['shape']}: {e['ms']:.4f} ms, CUPTI {e['cupti_ms']} ms "
              f"(bound {e['bound_ms']:.4f} ms by {e['bound_by']}), plain {e['plain_ms']:.4f} ms, "
              f"library {e['library_ms']}, max|err| {e['max_abs_err']:.3g}"
              + (f" (row-relative {e['row_rel_err']:.3g}, max|plain| {e['out_max']:.3g})"
                 if "row_rel_err" in e else "") + f", {e['launches']} launches")
    for name, wd in (("wkv6", wkv6_extra["decode"]), ("rglru", rglru_extra["decode"])):
        print(f"[main-path] {name} decode step {wd['shape']}: {wd['ms']:.4f} ms, CUPTI "
              f"{wd['cupti_ms']} ms (bound {wd['bound_ms']:.4f} ms by {wd['bound_by']}), plain "
              f"{wd['plain_ms']:.4f} ms, max|err| {wd['max_abs_err']:.3g}")

    # ---- 5. parity in fp32: kernels vs plain versions ---------------------
    @contextlib.contextmanager
    def plain_kernels():
        """Swap every ops entry point for its plain version — the reference
        leg, made here and visibly, never inside the package."""
        saved = {n: getattr(ops, n) for n in kern}
        for n in kern:
            setattr(ops, n, plain[n])
        before = sum(fn.launches for fn in kernel.values())
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)
        check(sum(fn.launches for fn in kernel.values()) == before,
              "a kernel launched inside the plain leg")

    def parity(label, run):
        before = sum(fn.launches for fn in kernel.values())
        logits_k, streams_k = run()
        check(sum(fn.launches for fn in kernel.values()) > before,
              f"{label}: fp32 run launched no kernel")
        with plain_kernels():
            logits_p, streams_p = run()
        logit_err = (logits_k - logits_p).abs().max().item()
        same = sum(a == b for a, b in zip(streams_k, streams_p))
        print(f"[parity] {label} fp32 prefill logits max|kernel - plain| {logit_err:.3g} "
              f"(tol {LOGIT_TOL}); greedy streams identical {same}/{len(streams_k)} "
              f"({sum(map(len, streams_k))} tokens)")
        check(logit_err <= LOGIT_TOL, f"{label}: fp32 prefill logits differ by {logit_err:.3g}")
        check(same == len(streams_k), f"{label}: fp32 greedy streams differ")
        results.setdefault("parity", {})[label] = dict(logit_err=logit_err, identical=same,
                                                       n=len(streams_k))

    model32 = Model(dataclasses.replace(cfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    probe = serving_engine(model32, dev)
    first = serving_requests()[:8]
    L = probe._bucket_len(max(len(r.tokens) for r in first))
    tokens, lengths = probe.tok.pad_batch([r.tokens for r in first], -(-L // 16) * 16)
    tokens, lengths = torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev)
    del probe

    def serve_fp32(paged):
        def run():
            logits, _ = model32.prefill(tokens, lengths=lengths)
            eng, rs = serving_engine(model32, dev, paged=paged), serving_requests()
            eng.serve(rs)
            torch.cuda.synchronize()
            return logits, [r.out_tokens for r in rs]
        return run

    parity("paged", serve_fp32(True))
    parity("contiguous", serve_fp32(False))
    del model32
    torch.cuda.empty_cache()
    rmodel32 = Model(dataclasses.replace(rcfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def rwkv_fp32():
        logits, streams, _, _ = greedy(rmodel32, prompts, n_steps)
        return logits, streams.tolist()

    parity("rwkv6", rwkv_fp32)
    del rmodel32
    torch.cuda.empty_cache()
    gmodel32 = Model(dataclasses.replace(gcfg, dtype="float32"), device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def rgemma_fp32():
        logits, streams, _, _ = greedy(gmodel32, g_prompts, n_steps, max_len=g_max_len)
        return logits, streams.tolist()

    parity("recurrentgemma", rgemma_fp32)
    del gmodel32

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results["kernels"] = entries
    (out_dir / "chip_smoke_results.json").write_text(json.dumps(results, indent=1))
    # |kernel − plain| ≤ atol + rtol·|plain| is the check each entry passed, with
    # |plain| taken element by element, or (scale "row") as the max of the
    # output row (the last axis) the element lies in
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "atol", "rtol",
            "scale", "ms", "cupti_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for e in entries:
        e.setdefault("scale", "element")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
