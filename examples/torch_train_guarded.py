"""End-to-end guarded training over the PyTorch/CUDA port: corrupt
batches are skipped, training survives a simulated crash, and resumes
from the checkpoint (the steps of `train_guarded.py`, over
`repro_torch`).

    PYTHONPATH=src python examples/torch_train_guarded.py        # GPU, tiny
    PYTHONPATH=src python examples/torch_train_guarded.py --device cpu
    PYTHONPATH=src python examples/torch_train_guarded.py --scale small \\
        --steps 300             # ~100M-parameter class, a few hundred steps

The initial weights are drawn from seed 0 on the port's generators,
which are not the JAX package's: the losses differ from the twin's, the
guard's skips do not.
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.guard import GuardConfig
from repro_torch.engine.engine import resolve_device
from repro_torch.launch.train import train

GUARD = GuardConfig(m=3.0, warmup_steps=8, channels=2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "small"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.scale == "tiny" else cfg.reduced(
        n_layers=8, d_model=768, n_heads=12, n_kv=4, head_dim=64,
        d_ff=3072 if cfg.d_ff else 0, vocab=32768)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        half = args.steps // 2
        print(f"=== phase 1: train to step {half} with corrupt batches every 7 steps "
              f" (TEDA guard active) ===")
        train(cfg, half, args.batch, args.seq, ckpt, device=dev,
              corrupt_every=7, save_every=max(half // 2, 1),
              guard_cfg=GUARD)

        print("=== simulated crash; phase 2: resume from checkpoint ===")
        _, hist, stats = train(cfg, args.steps, args.batch, args.seq,
                               ckpt, resume=True, device=dev,
                               corrupt_every=7, save_every=args.steps,
                               guard_cfg=GUARD)
        first, last = hist[0]["loss"], hist[-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f}; guard skipped "
              f"{stats['skipped']} corrupt steps")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
