#!/usr/bin/env python3
"""Decode, WKV6 and RG-LRU kernels of two source trees on one card, timed in turns.

    python3 benchmarks/torch_decode_turns.py --parent DIR [--rounds 7]

Times, from this checkout ("change") and from the tree unpacked at ``DIR``
("parent", for example ``git archive`` of an earlier commit under the
gitignored ``build/``), each through its own tree's wrapper and kernel
library:

* the paged and contiguous decode-attention kernels at the serving main
  path's shapes (q (8, 1, 16, 64) bf16);
* the ring decode at RecurrentGemma-9B's step (q (4, 1, 16, 256) bf16
  against 2,048-slot rings k/v (4, 2048, 1, 256), every slot live);
* WKV6 at RWKV6-3B's prefill (r/k/v (4, 512, 40, 64) bf16) and decode step
  ((4, 1, 40, 64)), both with a carried state;
* the RG-LRU scan at RecurrentGemma-9B's prefill (x (4, 3072, 4096) bf16)
  and step ((4, 1, 4096)), with a carried state and log-gates of the
  model's form −8 · softplus(Λ) · σ(r), Λ ~ U(−1, 1), r ~ N(0, 1).

``DIR``'s ``paged_attention.cu``, ``decode_attention.cu``, ``rwkv6_scan.cu``
and ``rglru_scan.cu`` are compiled with ``nvcc`` and the port's own flags
into ``DIR/build/turn_libs/``.  A third version, "fp64", is this checkout's
RG-LRU kernel with exp(2a) taken in fp64 for every gate (its ``FP64_BAND``
set below every input), timed beside the other two for the RG-LRU cases.

Each round times the versions in turns (the order flips every round)
after each of two L2 flushes of a 128 MB buffer: writing it (``timed_ms`` of
``chip_smoke.py``, the yardstick of its ``ms``) and reading it.  Beside them
it times, in the same round and under the same flush, SDPA's masked call on
the contiguous inputs (the contiguous kernel's ``library_ms``) and a no-op
(one-element add), the floor that an event-timed launch cannot go below.
Every round then reads each kernel's CUPTI device time a call from a
torch.profiler trace (summed over the kernels a call runs; it leaves out any
wait for the host) after the reading flush, as ``chip_smoke.device_ms``
reads it: where the profiler lost records, a kernel's time a record counts
once a call, and the records a call it kept stand beside each reading.
Once per version it also reads CUPTI with the L2 warm and after each
flush, and the host time of one wrapper call.  Every number is a CUDA-event,
CUPTI or host clock mean in milliseconds; rounds go to
``chiprun_out/decode_turns.json`` with the card's name and power limit from
nvidia-smi.  Needs a CUDA device.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("paged_attention", "decode_attention", "rwkv6_scan", "rglru_scan")
LENGTHS = [210, 210, 210, 209, 213, 213, 212, 213]   # the serving path's recorded lengths
SEED = 0


def timed_read_ms(fn, iters, flush):
    """``chip_smoke.timed_ms`` with a reading flush: the 128 MB buffer is
    read (a max over it) before each launch instead of written."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.max()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def build_parent(parent: Path, build):
    """Compile the parent tree's sources of ``NAMES``; returns name -> CDLL."""
    out_dir = parent / "build" / "turn_libs"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for n in NAMES:
        src = parent / "src" / "repro_torch" / "csrc" / f"{n}.cu"
        out = out_dir / f"lib{n}.so"
        procs[n] = (subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), out)
    libs = {}
    for n, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the parent's {n}.cu:\n{log}")
        libs[n] = ctypes.CDLL(str(out))
    return libs


def build_fp64_rglru(build):
    """This checkout's RG-LRU kernel with exp(2a) in fp64 for every gate."""
    src = (build.CSRC / "rglru_scan.cu").read_text()
    band = "constexpr float FP64_BAND = -0.5f;"
    if band not in src:
        raise SystemExit("rglru_scan.cu no longer states FP64_BAND as this script expects")
    out_dir = build.BUILD_DIR / "turn_libs"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "rglru_scan_fp64.cu"
    path.write_text(src.replace(band, "constexpr float FP64_BAND = -1e30f;")
                    .replace('#include "common.cuh"', f'#include "{build.CSRC}/common.cuh"'))
    out = out_dir / "librglru_scan_fp64.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the fp64 RG-LRU variant:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def load_wrappers(tree: Path):
    """The tree's wrapper modules of ``NAMES``, loaded from its files under their own
    names (they import ``build`` and the plain versions from this checkout's
    package, so ``build._loaded`` picks the library they launch)."""
    mods = {}
    for n in NAMES:
        spec = importlib.util.spec_from_file_location(
            f"parent_{n}", tree / "src" / "repro_torch" / "kernels" / f"{n}.py")
        mods[n] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[n])
    return mods


def cupti_ms(fn, kernel_substr, before=None):
    """``chip_smoke.device_ms``'s reading of one call of ``fn`` (a kernel's
    time a record once a call where torch.profiler lost CUPTI records), and
    beside it the records a call it kept: the fewest among the call's
    kernels, below 1 where records were lost."""
    from chip_smoke import device_ms

    records = {}
    ms = device_ms(fn, kernel_substr, before=before, records=records)
    return ms, min((n for n, _ in records.values()), default=0.0)


def host_ms(fn, iters=200):
    """Host time of one call, the mean over ``iters`` calls issued back to
    back (the queue absorbs the device work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the parent tree (its src/repro_torch/csrc is built)")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_turns: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import timed_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import rwkv6_scan as wkv6_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    build.build_all(NAMES)
    libs = {"change": {n: build.load(n) for n in NAMES},
            "parent": build_parent(args.parent.resolve(), build)}
    libs["fp64"] = dict(libs["change"], rglru_scan=build_fp64_rglru(build))
    parent_mods = load_wrappers(args.parent.resolve())
    wrappers = {"change": {"paged": paged_mod.paged_attention_cuda,
                           "decode": decode_mod.decode_attention_cuda,
                           "wkv6": wkv6_mod.wkv6_cuda, "rglru": rglru_mod.rglru_cuda},
                "parent": {"paged": parent_mods["paged_attention"].paged_attention_cuda,
                           "decode": parent_mods["decode_attention"].decode_attention_cuda,
                           "wkv6": parent_mods["rwkv6_scan"].wkv6_cuda,
                           "rglru": parent_mods["rglru_scan"].rglru_cuda}}
    wrappers["fp64"] = wrappers["change"]

    def use(version):
        for n in NAMES:
            build._loaded[n] = libs[version][n]

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B, H, D, ps, P, max_len, horizon = 8, 16, 64, 16, 512, 1024, 256
    q = randn(B, 1, H, D)
    k_pool, v_pool = randn(P, ps, H, D), randn(P, ps, H, D)
    pages = torch.randperm(P, generator=torch.Generator().manual_seed(SEED))
    table = pages[:B * (horizon // ps)].reshape(B, horizon // ps).to(torch.int32).to(dev)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    k_cache, v_cache = randn(B, max_len, H, D), randn(B, max_len, H, D)
    k, v = k_cache[:, :horizon], v_cache[:, :horizon]
    sq = q.transpose(1, 2).contiguous()
    sk, sv = (x.transpose(1, 2).contiguous() for x in (k, v))
    smask = (torch.arange(horizon, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    noop_x = torch.zeros(1, device=dev)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def wkv6_args(T, Bw=4, Hw=40, Dw=64):
        """RWKV6-3B's shapes in bf16: RWKV6's own decay range, a carried state."""
        r_, k_, v_ = (randn(Bw, T, Hw, Dw) for _ in range(3))
        w_ = torch.exp(-torch.exp(torch.rand((Bw, T, Hw, Dw), generator=gen, device=dev) - 0.5))
        u_ = (torch.rand((Hw, Dw), generator=gen, device=dev) - 0.5).to(torch.bfloat16)
        s_ = 0.3 * torch.randn((Bw, Hw, Dw, Dw), generator=gen, device=dev)
        return r_, k_, v_, w_, u_, s_

    wkv6_prefill, wkv6_step = wkv6_args(512), wkv6_args(1)

    def rglru_args(T, Bg=4, Wg=4096):
        """RecurrentGemma-9B's shapes in bf16: log-gates of the model's form, a
        carried state."""
        x_ = randn(Bg, T, Wg)
        lam = 2 * torch.rand((Wg,), generator=gen, device=dev) - 1
        r_ = torch.randn((Bg, T, Wg), generator=gen, device=dev)
        a_ = -8 * torch.nn.functional.softplus(lam) * torch.sigmoid(r_)
        return x_, a_, torch.randn((Bg, Wg), generator=gen, device=dev)

    rglru_prefill, rglru_step = rglru_args(3072), rglru_args(1)
    ring_q, ring_k, ring_v = randn(4, 1, 16, 256), randn(4, 2048, 1, 256), randn(4, 2048, 1, 256)
    ring_len = torch.full((4,), 2048, dtype=torch.int32, device=dev)

    def calls(version):
        paged, decode = wrappers[version]["paged"], wrappers[version]["decode"]
        wkv6, rglru = wrappers[version]["wkv6"], wrappers[version]["rglru"]
        fns = {"paged": lambda: paged(q, k_pool, v_pool, table, lengths),
               "decode": lambda: decode(q, k, v, lengths),
               "ring_decode": lambda: decode(ring_q, ring_k, ring_v, ring_len),
               "wkv6_prefill": lambda: wkv6(*wkv6_prefill),
               "wkv6_step": lambda: wkv6(*wkv6_step),
               "rglru_prefill": lambda: rglru(*rglru_prefill),
               "rglru_step": lambda: rglru(*rglru_step)}
        if version == "fp64":
            return {n: fn for n, fn in fns.items() if n.startswith("rglru")}
        return fns

    want = {"paged": paged_mod.paged_attention_plain(q, k_pool, v_pool, table, lengths),
            "decode": decode_mod.decode_attention_plain(q, k, v, lengths),
            "ring_decode": decode_mod.decode_attention_plain(ring_q, ring_k, ring_v, ring_len),
            "wkv6_prefill": wkv6_mod.wkv6_plain(*wkv6_prefill),
            "wkv6_step": wkv6_mod.wkv6_plain(*wkv6_step),
            "rglru_prefill": rglru_mod.rglru_plain(*rglru_prefill),
            "rglru_step": rglru_mod.rglru_plain(*rglru_step)}
    kernel_names = {"paged": "paged_decode_kernel", "decode": "decode_", "ring_decode": "decode_",
                    "wkv6_prefill": "wkv6", "wkv6_step": "wkv6", "rglru_prefill": "rglru_",
                    "rglru_step": "rglru_"}

    def max_err(name, got):
        """Max abs error of the output (decode), or of the output and the
        state scaled by 1 + |plain| (WKV6 and RG-LRU, whose outputs run to
        tens); raises past 2e-2 for a bf16 output or 2e-5 for an fp32 state."""
        if "decode" in name or name == "paged":
            err = (got.float() - want[name].float()).abs().max().item()
            bad = err > 2e-2
        else:
            errs = [((g.float() - p.float()).abs() / (1 + p.float().abs())).max().item()
                    for g, p in zip(got, want[name])]
            err, bad = max(errs), errs[0] > 2e-2 or errs[1] > 2e-5
        if bad:
            raise SystemExit(f"{name}: error {err:.3g} past its tolerance")
        return err

    diag = {}
    for version in ("parent", "change", "fp64"):
        use(version)
        for name, fn in calls(version).items():
            err = max_err(name, fn())
            kname = kernel_names[name]
            diag[f"{version} {name}"] = dict(max_abs_err=err, host_ms=host_ms(fn))
            for key, before in (("device_ms", None), ("device_ms_write", flush.zero_),
                                ("device_ms_read", flush.max)):
                ms, kept = cupti_ms(fn, kname, before=before)
                diag[f"{version} {name}"].update({key: ms, f"{key}_records_a_call": kept})
            print(f"[diag] {version} {name}: {diag[f'{version} {name}']}")
    noop = lambda: noop_x.add_(1)  # noqa: E731
    diag["noop"] = dict(host_ms=host_ms(noop))
    for key, before in (("device_ms", None), ("device_ms_write", flush.zero_),
                        ("device_ms_read", flush.max)):
        ms, kept = cupti_ms(noop, "_add", before=before)
        diag["noop"].update({key: ms, f"{key}_records_a_call": kept})
    print(f"[diag] noop: {diag['noop']}")

    timers = {"write": lambda fn: timed_ms(fn, 50, flush),
              "read": lambda fn: timed_read_ms(fn, 50, flush)}
    rounds = []
    for r in range(args.rounds):
        order = ("parent", "change", "fp64") if r % 2 == 0 else ("fp64", "change", "parent")
        row = {"round": r, "order": list(order)}
        for mode, timer in timers.items():
            for version in order:
                use(version)
                for name, fn in calls(version).items():
                    row[f"{mode} {version} {name}"] = timer(fn)
            row[f"{mode} sdpa"] = timer(lambda: sdpa(sq, sk, sv, attn_mask=smask))
            row[f"{mode} noop"] = timer(noop)
        for version in order:
            use(version)
            for name, fn in calls(version).items():
                row[f"cupti {version} {name}"], row[f"cupti records a call {version} {name}"] = \
                    cupti_ms(fn, kernel_names[name], before=flush.max)
        rounds.append(row)
        print(f"[round {r}] " + ", ".join(f"{key} {val:.4f}" for key, val in row.items()
                                          if isinstance(val, float)))
    summary = {key: [row[key] for row in rounds] for key in rounds[0]
               if isinstance(rounds[0][key], float)}
    print(f"[summary] {smi}")
    for key, vals in summary.items():
        unit = "" if "records" in key else " ms"
        print(f"[summary] {key}: min {min(vals):.4f} median {float(np.median(vals)):.4f} "
              f"max {max(vals):.4f}{unit}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_turns.json").write_text(json.dumps(
        dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), lengths=LENGTHS,
             diagnostics=diag, rounds=rounds), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
