"""End to end: train a ~100M-param dense LM with the full stack --
fault-tolerant trainer, checkpoints, data pipeline -- on one device.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300   # ~100M
    PYTHONPATH=src python -m repro_torch.examples.train_lm --quick       # tiny/CI
    PYTHONPATH=src python -m repro_torch.examples.train_lm --quick --device cpu

On a card every layer's attention runs the flash attention kernel forward
and backward.  Training resumes from the newest checkpoint in
``--ckpt-dir``: give a fresh directory to start over.  Beside the JAX
package's lines it prints the median step time and the tokens per second
at that median.
"""

import argparse
import os
import statistics
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import get_model, param_shapes
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, train


def lm_100m() -> ArchConfig:
    """~100M params: 12L, d=768, 12H, ff=3072, vocab 32k (GPT-2-small-ish)."""
    return ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32_000, head_dim=64,
    )


def lm_quick() -> ArchConfig:
    return ArchConfig(
        name="lm-quick", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = lm_quick() if args.quick else lm_100m()
    if args.quick:
        args.steps = min(args.steps, 30)
    model = get_model(cfg)
    n_params = sum(x.numel() for x in
                   adamw.tree_leaves(param_shapes(model)))
    print(f"arch {cfg.name}: {n_params/1e6:.1f}M params")

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    train_cfg = TrainConfig(total_steps=args.steps,
                            ckpt_every=max(args.steps // 5, 10),
                            log_every=10, ckpt_dir=args.ckpt_dir)
    opt_cfg = adamw.AdamWConfig(lr_peak=6e-4, warmup_steps=args.steps // 10,
                                total_steps=args.steps)
    out = train(model, data_cfg, train_cfg, opt_cfg, device=args.device)
    losses = out["losses"]
    k = max(len(losses) // 10, 1)
    print(f"loss: first-{k} avg {sum(losses[:k])/k:.4f} -> "
          f"last-{k} avg {sum(losses[-k:])/k:.4f}")
    assert sum(losses[-k:]) < sum(losses[:k]), "loss did not decrease!"
    print("training loss decreased ✓ (resume-safe checkpoints in",
          train_cfg.ckpt_dir + ")")
    median = statistics.median(out["step_seconds"])
    print(f"step time: median {median * 1e3:.2f} ms over "
          f"{len(out['step_seconds'])} steps, "
          f"{args.batch * args.seq / median:.0f} tokens/s")


if __name__ == "__main__":
    main()
