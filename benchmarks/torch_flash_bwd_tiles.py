#!/usr/bin/env python3
"""The fp32 flash-attention backward with tiles of 32 rows against 64, on one card.

    python3 benchmarks/torch_flash_bwd_tiles.py [--rounds 2]

``csrc/flash_attention_bwd.cu`` runs fp32 on the CUDA cores in tiles of
``FP_T`` = 64 rows (queries in the dq kernel, keys in the dkdv kernel).
This script compiles the source as it is and a copy with ``FP_T`` set to
32, with ``nvcc`` and the port's own flags, into the gitignored
``build/repro_torch_kernels/``, and runs both at:

* the three shapes that the tiny pool's training (``chip_smoke.py`` h3)
  gives the kernel: q/k/v/dO (8, 192, H, 32) fp32, causal, with H = Hk =
  2, 4 and 6 (tiny-s, tiny-m, tiny-l: 48, 96 and 144 blocks of 64 rows);
* three shapes whose B·H·ceil(S/64) is above the H100's 132 SMs, one for
  each head width: (4, 320, 8, Hk, D) with D = 16 at G = 1, D = 32 at
  G = 4 with a window of 64, and D = 64 at G = 4;
* Qwen1.5-0.5B's training shape in fp32, (8, 512, 16, 64), causal.

Each version is first held against ``flash_attention_backward_plain``
(1e-4 row-relative, as ``chip_smoke.py`` holds the kernel) and launched
twice (the same bits required).  Then each round reads each version's
CUPTI device time a call (both kernels summed, and each kernel alone) from
a torch.profiler trace of 50 calls, each after an L2 flush (a 128 MB
write), the versions in turns: 32, 64, 64, 32.  Prints one line a shape
and writes every reading, with the card's name and power limit from
nvidia-smi, to ``chiprun_out/flash_bwd_tiles.json``.  Exits 1 if a version
is wrong.  Needs a CUDA device.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROWS = (32, 64)
TOL = 1e-4                  # row-relative, fp32
SHAPES = (                  # label, B, S, H, Hk, D, window
    ("h3 tiny-s", 8, 192, 2, 2, 32, None),
    ("h3 tiny-m", 8, 192, 4, 4, 32, None),
    ("h3 tiny-l", 8, 192, 6, 6, 32, None),
    ("above-sms D=16 G=1", 4, 320, 8, 8, 16, None),
    ("above-sms D=32 G=4 window", 4, 320, 8, 2, 32, 64),
    ("above-sms D=64 G=4", 4, 320, 8, 2, 64, None),
    ("qwen1.5-0.5b train", 8, 512, 16, 16, 64, None),
)


def build_versions(build) -> dict:
    """One library a tile height, both ``nvcc`` started together."""
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    line = "constexpr int FP_T = 64;"
    if text.count(line) != 1:
        raise SystemExit(f"flash_attention_bwd.cu does not hold {line!r} once")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows in ROWS:
        src = build.BUILD_DIR / f"flash_attention_bwd_rows{rows}.cu"
        src.write_text(text.replace(line, f"constexpr int FP_T = {rows};"))
        out = src.with_name(f"libflash_attention_bwd_rows{rows}.so")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out),
               str(src)]
        procs[rows] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for rows, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed with FP_T = {rows}:\n{log}")
        fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[rows] = fn
    return libs


def backward(fn, q, k, v, do, window):
    """One call of the C entry, as ``flash_attention_backward_cuda`` makes it."""
    B, S, H, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, S, H,
             k.shape[2], D, 0, 1, int(window or 0), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward launch failed with CUDA error {err}")
    return dq, dk, dv


def row_rel_err(got, want):
    """Max over rows of max|got − want| over the row's max|want| (as chip_smoke.py)."""
    d = (got - want).abs().amax(-1)
    return (d / want.abs().amax(-1).clamp(min=1e-6)).max().item()


def cupti_ms(fn, flush, iters=50):
    """CUPTI device time of one call of ``fn`` (every kernel whose name holds
    ``bwd_``), and of each kernel alone, over ``iters`` calls, each after an
    L2 flush; with the records the trace kept a call.  ``ms`` is None where
    the trace kept no record of the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.count and "bwd_" in e.key]
    per = {re.search(r"bwd_\w+<[^>]*>", e.key).group(0): e.self_device_time_total / e.count / 1e3
           for e in rows}
    return dict(ms=sum(per.values()) if per else None, kernels=per,
                records_a_call=min((e.count / iters for e in rows), default=0.0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_backward_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_versions(build)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    gen = np.random.default_rng(0)
    out = dict(nvidia_smi=smi, sms=sms, shapes=[])
    ok = True
    for label, B, S, H, Hk, D, window in SHAPES:
        q, k, v, do = (torch.from_numpy(gen.standard_normal((B, S, h, D), dtype=np.float32)).to(dev)
                       for h in (H, Hk, Hk, H))
        want = flash_attention_backward_plain(q, k, v, do, window=window)
        rec = dict(label=label, B=B, S=S, H=H, Hk=Hk, D=D, window=window,
                   blocks_of_64=B * H * -(-S // 64), errors={}, identical={},
                   ms={r: [] for r in ROWS})
        for rows, fn in libs.items():
            got = backward(fn, q, k, v, do, window)
            again = backward(fn, q, k, v, do, window)
            torch.cuda.synchronize()
            rec["errors"][rows] = [row_rel_err(a, b) for a, b in zip(got, want)]
            rec["identical"][rows] = all(torch.equal(a, b) for a, b in zip(got, again))
            ok &= rec["identical"][rows] and max(rec["errors"][rows]) <= TOL
        for _ in range(args.rounds):
            for rows in (32, 64, 64, 32):
                rec["ms"][rows].append(cupti_ms(
                    lambda: backward(libs[rows], q, k, v, do, window), flush))
        out["shapes"].append(rec)
        mean = {r: float(np.mean([x["ms"] for x in rec["ms"][r] if x["ms"] is not None]))
                for r in ROWS}
        print(f"{label} (B={B} S={S} H={H} Hk={Hk} D={D} window={window}; "
              f"{rec['blocks_of_64']} blocks of 64 on {sms} SMs): "
              + "; ".join(f"{r} rows {[x['ms'] and round(x['ms'], 4) for x in rec['ms'][r]]} ms "
                          f"(records a call {min(x['records_a_call'] for x in rec['ms'][r])}, "
                          f"max row-rel err {max(rec['errors'][r]):.3g}, "
                          f"{'identical' if rec['identical'][r] else 'DIFFER'})" for r in ROWS)
              + f"; 64/32 = {mean[64] / mean[32]:.3f}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_bwd_tiles.json").write_text(json.dumps(out, indent=1))
    print(f"versions {'right' if ok else 'WRONG'} at every shape")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
