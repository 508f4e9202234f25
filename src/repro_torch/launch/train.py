"""Training launcher of the port: any registered architecture, at its
``reduced()`` size, on one device::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-s --steps 12 \\
        --batch 4 --seq 32 --device cpu

Prints what the JAX package's launcher prints (parameters and start step,
then the loss every 10 steps).  ``--ckpt DIR`` checkpoints into DIR and
resumes from its latest step.  The run is on the card unless ``--device
cpu`` is given; weights start from ``Model.init`` with a generator seeded 0.
``--mode lower`` (the production mesh's compile check) waits for the mesh
slice and raises ``NotImplementedError``.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mode", choices=["local", "lower"], default="local")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true",
                    help="kept for the JAX launcher's flags: a run with --ckpt always "
                         "resumes from the latest checkpoint there")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode == "lower":
        raise NotImplementedError("launch.train --mode lower: the production mesh's "
                                  "compile check is not ported yet (the mesh slice)")
    import torch

    from repro_torch.config import ShardingConfig, get_arch
    from repro_torch.data.pipeline import ShardedPipeline, synthetic_lm_stream
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import Trainer

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model = Model(cfg, ShardingConfig(remat="none", microbatches=args.microbatches), device=dev)
    opt = adamw(cosine_schedule(args.lr, warmup=10, total=args.steps), grad_clip=1.0)
    trainer = Trainer(model, opt, ckpt_dir=args.ckpt or None)
    params, opt_state, start = trainer.restore_or_init(
        torch.Generator(device=dev).manual_seed(0))
    print(f"{cfg.name}: {model.param_count() / 1e6:.2f}M params, start step {start}")

    stream = synthetic_lm_stream(cfg.vocab_size, args.batch, args.seq, seed=start)
    pipeline = ShardedPipeline(stream, device=dev)
    n = max(args.steps - start, 0)
    batches = (b for _, b in zip(range(n), pipeline))
    params, opt_state, hist = trainer.fit(params, opt_state, batches,
                                          start_step=start, log_every=10)
    pipeline.close()
    for h in hist:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} ({h['time']:.0f}s)")


if __name__ == "__main__":
    main()
