#!/usr/bin/env python3
"""The flash and wide-decode launchers on every visible card, each launch held to its plain version.

    python3 benchmarks/torch_smem_per_device.py [--csrc DIR]

``flash_tc_kernel`` (bf16 flash attention at D=128) and ``decode_wide_kernel``
(ring decode at D=256) take more than 48 KB of dynamic shared memory, so
their launchers raise the kernel's cap first
(``cudaFuncAttributeMaxDynamicSharedMemorySize``).  That attribute belongs
to a device.  This script launches both kernels on card 0, then on every
other visible card (``torch.cuda.device(i)``), flash causal over q/k/v
(4, 64, 16, 128) and the decode at RecurrentGemma-9B's step (q (4, 1, 16,
256) over rings (4, 2048, 1, 256)), and holds each output to the plain
version (2e-2, bf16).  ``--csrc`` builds an earlier tree's
``src/repro_torch/csrc`` (unpacked under the gitignored ``build/`` with
``git archive``) in place of this one's: a launcher that kept the attribute
behind a flag once a process is refused on the second card.  Prints one
line a (card, kernel); exits 1 if a launch failed or disagreed.  Needs a
CUDA device, and two to say anything about the attribute.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 2e-2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, help="another src/repro_torch/csrc to build instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_smem_per_device: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod

    if args.csrc:
        build.CSRC = args.csrc.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.replace("\n", "; "))
    print(f"sources: {build.CSRC}; cards: {torch.cuda.device_count()}", flush=True)
    build.build_all(("flash_attention", "decode_attention"))
    ok = True
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(i)
        with torch.cuda.device(i):
            q, k, v = (torch.randn(4, 64, 16, 128, device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            dq = torch.randn(4, 1, 16, 256, device=dev, generator=gen).to(torch.bfloat16)
            dk, dv = (torch.randn(4, 2048, 1, 256, device=dev, generator=gen)
                      .to(torch.bfloat16) for _ in range(2))
            lengths = torch.full((4,), 2048, dtype=torch.int32, device=dev)
            for name, kernel, plain in (
                    ("flash_tc_kernel D=128", lambda: flash_mod.flash_attention_cuda(q, k, v),
                     lambda: flash_mod.flash_attention_plain(q, k, v)),
                    ("decode_wide_kernel D=256",
                     lambda: decode_mod.decode_attention_cuda(dq, dk, dv, lengths),
                     lambda: decode_mod.decode_attention_plain(dq, dk, dv, lengths))):
                try:
                    got = kernel()
                    torch.cuda.synchronize(dev)
                except RuntimeError as e:
                    print(f"card {i} {name}: REFUSED ({e})", flush=True)
                    ok = False
                    continue
                err = (got.float() - plain().float()).abs().max().item()
                print(f"card {i} {name}: max|kernel − plain| {err:.3g} (tol {TOL})", flush=True)
                ok &= err <= TOL
    print("every launch right" if ok else "a launch FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
