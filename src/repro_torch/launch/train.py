"""Training launcher of the port.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 8 \
        --batch 2 --seq 4096 --remat
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --device cpu

Runs the port's training loop (``training.trainer.train``: the final
checkpoint holds params and optimizer state) on one device, the
GPU unless ``--device cpu`` (without a card the default raises), at the
full config or with ``--smoke`` its reduced one.  The counterpart of the
reference's ``repro/launch/train.py`` without its mesh and shardings (the
plane meshes come last, ROADMAP.md queue 1 item 9).  Every family of
the registry trains (``models.model.check_trainable``): dense GQA, MLA
(minicpm3-4b), the frontends (internvl2-2b, whisper-small), RWKV6
(rwkv6-1.6b, its recurrence through ``ops.Wkv6Fn``), MoE (kimi-k2-1t-a32b,
arctic-480b: the reference's capacity drops and 0.01 x its aux loss) and
the hybrid (jamba-v0.1-52b, its Mamba layers' scan through
``ops.SelectiveScanFn``), each batch with the reference launcher's
stand-ins for the stubbed frontends (``training.trainer.frontend_inputs``).
No MoE config's float32 training state fits one card at full depth
(chip_smoke.py's train phase trains jamba-v0.1-52b at 2 of its 32
layers, full width).

    python -m repro_torch.launch.train --arch minicpm3-4b --steps 3 \
        --batch 1 --seq 4096 --remat
    python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 3 \
        --batch 2 --seq 4096 --remat --lr 1e-5
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--remat", action="store_true",
                    help="run each layer's forward again on the backward "
                         "pass (torch.utils.checkpoint)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    M.check_trainable(cfg)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"device={dev}")
    log_every = max(args.steps // 10, 1)
    tc = TrainConfig(steps=args.steps, log_every=log_every,
                     ckpt_path=args.ckpt, remat=args.remat,
                     opt=AdamWConfig(lr=args.lr, warmup_steps=log_every,
                                     total_steps=args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    train(cfg, tc, data_cfg, seed=args.seed, device=dev)
    if args.ckpt:
        print(f"saved {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
