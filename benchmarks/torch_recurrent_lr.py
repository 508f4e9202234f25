#!/usr/bin/env python3
"""The recurrent training paths of ``chip_smoke.py`` under several AdamW
schedules, and their checkpoint's round trip, on one card.

    python3 benchmarks/torch_recurrent_lr.py

Trains, in bf16 through the port's kernels (WKV6, RG-LRU and the flash
attention forwards and backwards), from one seeded init a schedule:

* path n: full-width, full-depth RWKV6-3B, 12 steps of 4 x 512 tokens;
* path o: RecurrentGemma-9B at full width, its first 3 of 38 layers (one
  rglru, rglru, local group), 8 steps of 2 x 3,072 tokens;

both on ``synthetic_lm_stream`` through ``ShardedPipeline`` with a
``Trainer`` (``remat="none"``, clip 1.0), as ``chip_smoke.py`` builds them.
The schedules are ``cosine_schedule(peak, warmup, total=steps)`` for each
(peak, warmup) of ``SCHEDULES``.  Prints one line a run: the losses, the
grad norms, the largest rise of a loss above the lowest before it, and the
kernels' launches.  After a path's last run its trained state (parameters
and moments) is saved with ``checkpoint.save_state`` and read back with
``load_state`` into zeroed tensors on the card, each timed, and compared
bit for bit.  Writes every reading, with the card's name and power limit
from nvidia-smi, to ``chiprun_out/recurrent_lr.json``.  Exits 1 if a
restore differs.  Needs a CUDA device.
"""
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SCHEDULES = ((3e-3, 10), (1e-3, 2), (3e-4, 2))      # (peak lr, warmup steps)
PATHS = (                                           # label, arch, layers, steps, batch, seq
    ("n", "rwkv6-3b", None, 12, 4, 512),
    ("o", "recurrentgemma-9b", 3, 8, 2, 3072),
)


def largest_rise(losses) -> float:
    """max over t of losses[t] − min(losses[:t]): how far a loss climbed
    above the lowest one before it (0 when none did)."""
    return max([0.0] + [losses[t] - min(losses[:t]) for t in range(1, len(losses))])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.config import ShardingConfig, get_arch
    from repro_torch.data.pipeline import ShardedPipeline, synthetic_lm_stream
    from repro_torch.kernels import flash_attention, rglru_scan, rwkv6_scan
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import Trainer, train_state

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    wrappers = {"wkv6": rwkv6_scan.wkv6_cuda, "wkv6_bwd": rwkv6_scan.wkv6_backward_cuda,
                "rglru": rglru_scan.rglru_cuda, "rglru_bwd": rglru_scan.rglru_backward_cuda,
                "flash": flash_attention.flash_attention_cuda,
                "flash_bwd": flash_attention.flash_attention_backward_cuda}
    dev = torch.device("cuda")
    out = {"device": smi, "torch": torch.__version__, "runs": [], "checkpoints": []}
    ok = True
    for label, arch, layers, steps, batch, seq in PATHS:
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        for peak, warmup in SCHEDULES:
            for fn in wrappers.values():
                fn.launches = 0
            model = Model(cfg, ShardingConfig(remat="none"), device=dev)
            tr = Trainer(model, adamw(cosine_schedule(peak, warmup=warmup, total=steps),
                                      grad_clip=1.0))
            params, state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
            pipe = ShardedPipeline(synthetic_lm_stream(cfg.vocab_size, batch, seq, seed=SEED),
                                   device=dev)
            t0 = time.perf_counter()
            params, state, hist = tr.fit(params, state, (b for _, b in zip(range(steps), pipe)),
                                         log_every=1)
            seconds = time.perf_counter() - t0
            pipe.close()
            losses = [h["loss"] for h in hist]
            norms = [h["grad_norm"] for h in hist]
            launched = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
            run = dict(path=label, arch=arch, layers=cfg.n_layers, steps=steps, batch=batch,
                       seq=seq, peak_lr=peak, warmup=warmup, losses=losses, grad_norms=norms,
                       largest_rise=largest_rise(losses), seconds=seconds, launches=launched)
            out["runs"].append(run)
            print(f"[{label}] {arch} ({cfg.n_layers} layers) peak {peak:g} warmup {warmup}: "
                  f"losses {[round(x, 4) for x in losses]}, grad norms "
                  f"{[round(x, 3) for x in norms]}, largest rise {run['largest_rise']:.4f}, "
                  f"last 3 mean {np.mean(losses[-3:]):.4f}; {seconds:.1f}s; launches {launched}",
                  flush=True)
            if (peak, warmup) == SCHEDULES[-1]:
                ok &= round_trip(label, train_state(params, state), out, save_state, load_state)
            del params, state, tr, model, pipe
            gc.collect()
            torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "recurrent_lr.json").write_text(json.dumps(out, indent=1))
    return 0 if ok else 1


def round_trip(label, state, out, save_state, load_state) -> bool:
    """Save ``state`` into the gitignored ``build/`` and read it back into
    zeroed tensors, each timed; True when every leaf comes back bit for bit."""
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    (ROOT / "build").mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="recurrent_lr_ckpt_", dir=ROOT / "build")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(state, directory, 1)
        save_s = time.perf_counter() - t0
        template = {k: torch.zeros_like(v) for k, v in state.items()}
        t0 = time.perf_counter()
        load_state(template, directory)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    differ = [k for k in state if not torch.equal(state[k], template[k])]
    del template
    out["checkpoints"].append(dict(path=label, tensors=len(state), bytes=n_bytes, save_s=save_s,
                                   load_s=load_s, differ=differ[:5]))
    print(f"[{label}] checkpoint of {len(state)} tensors, {n_bytes / 1e9:.2f} GB: saved in "
          f"{save_s:.1f}s, restored in {load_s:.1f}s, {len(differ)} differ", flush=True)
    return not differ


if __name__ == "__main__":
    sys.exit(main())
