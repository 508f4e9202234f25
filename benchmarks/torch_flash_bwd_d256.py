#!/usr/bin/env python3
"""The bf16 flash-attention backward at D=256 beside other builds of its source, on one card.

    python3 benchmarks/torch_flash_bwd_d256.py [--rounds 2] [--version NAME=PATH.cu ...]

At path o's shape in ``chip_smoke.py`` (RecurrentGemma-9B's local
attention trained on 2 x 3,072 tokens: q/dO (2, 3072, 16, 256), k/v (2,
3072, 1, 256) bf16, causal, window 2048) this script compiles
``src/repro_torch/csrc/flash_attention_bwd.cu`` as it is ("tree") and
every further copy of it named by ``--version`` (another commit's, unpacked
under the gitignored ``build/`` with ``git archive``, or a variant of the
file), each with ``nvcc`` and the port's flags into the gitignored
``build/repro_torch_kernels/``, all ``nvcc`` started together.  It prints
each build's ptxas lines for the D=256 kernels.

Each version is held against ``flash_attention_backward_plain`` (2e-2
row-relative, as ``chip_smoke.py`` holds the kernel), launched twice (the
same bits required), and its gradients are compared bit for bit with the
tree's.  Then each round reads each version's CUPTI device time a call
(its kernels summed, and each alone) from a torch.profiler trace of 20
calls, each after an L2 flush (a 128 MB write), the versions in turns and
then in the reverse order, with SDPA's backward under the same
causal-and-window mask (k/v repeated to 16 heads; the port never calls it)
among them.  Writes every reading, with the card's name and power limit
from nvidia-smi, to ``chiprun_out/flash_bwd_d256.json``.  Exits 1 if a
version is wrong.  Needs a CUDA device.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 2e-2                                  # row-relative, bf16
B, S, H, HK, D, WINDOW = 2, 3072, 16, 1, 256, 2048
ITERS = 20


def build_versions(build, versions: dict) -> dict:
    """One library a version, every ``nvcc`` started together; prints the
    D=256 kernels' ptxas lines."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in versions.items():
        out = build.BUILD_DIR / f"libflash_attention_bwd_{name}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m[1]
            elif "Used" in line and ("ILi256E" in entry or "wide" in entry):
                kernel = re.search(r"bwd_\w+?_kernel", entry)
                print(f"[{name}] {kernel[0] if kernel else entry}: "
                      f"{line.replace('ptxas info    : ', '').strip()}")
        fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def backward(fn, q, k, v, do):
    """One call of the C entry, as ``flash_attention_backward_cuda`` makes it."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, S, H, HK, D, 1,
             1, WINDOW, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward launch failed with CUDA error {err}")
    return dq, dk, dv


def row_rel_err(got, want):
    """Max over rows of max|got − want| over the row's max|want| (as chip_smoke.py)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp(min=1e-6)).max().item()


def cupti_ms(fn, flush, frag):
    """CUPTI device time of one call of ``fn`` (every kernel whose name holds
    ``frag``, None for all but the flush's) and of each kernel alone, over
    ``ITERS`` calls, each after an L2 flush; with the records kept a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.count and e.self_device_time_total > 0
            and (frag in e.key if frag else "FillFunctor<float>" not in e.key)]
    per = {e.key[:80]: e.self_device_time_total / min(e.count, ITERS) / 1e3 for e in rows}
    return dict(ms=sum(per.values()) if per else None, kernels=per,
                records_a_call=min((e.count / ITERS for e in rows), default=0.0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--version", action="append", default=[], metavar="NAME=PATH.cu",
                    help="another copy of flash_attention_bwd.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_d256: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    versions = {"tree": build.CSRC / "flash_attention_bwd.cu"}
    for spec in args.version:
        name, _, path = spec.partition("=")
        versions[name] = Path(path).resolve()
    fns = build_versions(build, versions)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(B, S, h, D, device=dev, generator=gen).to(torch.bfloat16)
                   for h in (H, HK, HK, H))
    want = flash_attention_backward_plain(q, k, v, do, window=WINDOW)
    out = dict(nvidia_smi=smi, shape=dict(q=[B, S, H, D], k=[B, S, HK, D], window=WINDOW),
               versions={})
    ok, tree = True, None
    for name, fn in fns.items():
        got, again = backward(fn, q, k, v, do), backward(fn, q, k, v, do)
        torch.cuda.synchronize()
        tree = tree or got
        rec = dict(errors=[row_rel_err(a, w) for a, w in zip(got, want)],
                   identical=all(torch.equal(a, b) for a, b in zip(got, again)),
                   tree_bits=all(torch.equal(a, b) for a, b in zip(got, tree)), ms=[])
        ok &= rec["identical"] and max(rec["errors"]) <= TOL
        out["versions"][name] = rec
        print(f"{name}: row-relative dq {rec['errors'][0]:.3g}, dk {rec['errors'][1]:.3g}, "
              f"dv {rec['errors'][2]:.3g}; two launches "
              f"{'identical' if rec['identical'] else 'DIFFER'}; the tree's bits: "
              f"{rec['tree_bits']}", flush=True)
        del got, again
    G = H // HK
    lq = q.transpose(1, 2).contiguous().requires_grad_()
    lk, lv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WINDOW)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
    ldo = do.transpose(1, 2).contiguous()
    calls = {name: (lambda fn=fn: backward(fn, q, k, v, do), "bwd_") for name, fn in fns.items()}
    calls["sdpa"] = (lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True), None)
    out["versions"]["sdpa"] = dict(ms=[])
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    order = list(calls)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            fn, frag = calls[name]
            out["versions"][name]["ms"].append(cupti_ms(fn, flush, frag))
    for name in order:
        ms = out["versions"][name]["ms"]
        print(f"{name}: CUPTI ms a call {[r['ms'] and round(r['ms'], 4) for r in ms]} "
              f"(records a call {min(r['records_a_call'] for r in ms)}); kernels "
              f"{ {k: round(x, 4) for k, x in ms[0]['kernels'].items()} }", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_bwd_d256.json").write_text(json.dumps(out, indent=1))
    print(f"versions {'right' if ok else 'WRONG'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
