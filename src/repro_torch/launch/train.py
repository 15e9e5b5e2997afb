"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The JAX package's launcher with the same flags, plus ``--device`` (default
``cuda``; the run raises without a card unless it is ``cpu``).  ``--smoke``
uses the reduced config, so any architecture trains on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --smoke --device cpu --steps 5

Without ``--smoke`` the config is the catalog's, at full width and depth.
It runs in one process on one device; the multi-host start-up of the JAX
package's launcher comes with the multi-device side of the port.
``--bf16-opt`` is accepted as the JAX package's launcher accepts it and,
as there, changes nothing.  Checkpoints go to ``--ckpt-dir`` (default: a
directory per config under the system's temporary directory), and a run
resumes from the newest one it finds there.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bf16-opt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_arch
    from ..data.pipeline import DataConfig
    from ..models import get_model
    from ..optim import adamw
    from ..runtime.trainer import TrainConfig, train

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = get_model(cfg)
    data_cfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
        frames_dim=cfg.d_model if cfg.family in ("encdec", "audio") else 0)
    train_cfg = TrainConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                               f"repro_torch_{cfg.name}"))
    opt_cfg = adamw.AdamWConfig(lr_peak=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    out = train(model, data_cfg, train_cfg, opt_cfg, seed=args.seed,
                device=args.device)
    losses = out["losses"]
    print(f"done: {len(losses)} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
