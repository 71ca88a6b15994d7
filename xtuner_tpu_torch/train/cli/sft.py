"""SFT / pretrain CLI (counterpart: `xtuner_tpu/train/cli/sft.py`, the
same flags).

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_moe_heavy.py
    python -m xtuner_tpu_torch.train.cli.sft --model qwen3-0-6b --dataset data.jsonl \
        --total-steps 100

`--optim Muon` raises ([muon]); `--load-from` and `--hf-interval` raise in
`Trainer` ([serve-rest]). `--device` (default `cuda`) is the port's one flag
of its own: the run is on the card, and fails without one, unless it says
`--device cpu`. `main` returns the trainer after `fit`.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ...datasets.config import DataloaderConfig, DatasetConfig
from ...model.registry import get_model_config
from ...parallel.mesh import MeshConfig
from ...config.optim import AdamWConfig, LRConfig
from ...utils.config import Config
from ..trainer import Trainer, TrainerConfig
from ... import not_ported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="xtuner-tpu SFT trainer (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help="python config file defining `trainer`")
    # flattened TrainingArguments (reference arguments/arguments.py:38)
    p.add_argument("--model", type=str, default=None, help="registry name or HF checkpoint dir")
    p.add_argument("--dataset", type=str, default=None, help="jsonl file or dir")
    p.add_argument("--dataset-type", type=str, default="openai_sft", choices=["openai_sft", "pretrain"])
    p.add_argument("--chat-template", type=str, default="qwen")
    p.add_argument("--load-from", type=str, default=None)
    p.add_argument("--tokenizer-path", type=str, default=None)
    p.add_argument("--pack-max-length", type=int, default=16384)
    p.add_argument("--global-batch-rows", type=int, default=8)
    p.add_argument("--micro-batch-rows", type=int, default=1)
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--epochs", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--work-dir", type=str, default="work_dirs")
    p.add_argument("--exp-name", type=str, default="sft")
    # optimizer / schedule (reference optimizer_group + lr_scheduler_group)
    p.add_argument("--optim", type=str, default="AdamW", choices=["AdamW", "Muon"])
    p.add_argument("--lr-min", type=float, default=1e-6)
    p.add_argument("--scheduler-type", type=str, default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    # dataset group
    p.add_argument("--max-length", type=int, default=None,
                   help="max single-sample length (reference max_length)")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--tokenize-num-proc", type=int, default=0)
    p.add_argument("--pack-level", type=str, default="soft", choices=["soft", "hard", "none"])
    # parallel group (reference fsdp_config flattened)
    p.add_argument("--dp-size", type=int, default=1)
    p.add_argument("--fsdp-size", type=int, default=-1)
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--sp-size", type=int, default=1)
    p.add_argument("--ep-size", type=int, default=1)
    p.add_argument("--remat-policy", type=str, default="full",
                   help="full|dots|none|save_attn|save_out_lse|save_attn_residuals|offload_attn")
    # checkpoint group (incl. selective resume, reference checkpoint_group)
    p.add_argument("--checkpoint-interval", type=int, default=None)
    p.add_argument("--checkpoint-max-keep", type=int, default=2)
    p.add_argument("--snapshot-interval", type=int, default=None)
    p.add_argument("--hf-interval", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-load-model", action="store_true")
    p.add_argument("--no-load-optimizer-states", action="store_true")
    p.add_argument("--no-load-dataset", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainerConfig:
    if args.config:
        cfg = Config.fromfile(args.config)
        trainer_cfg = cfg["trainer"]
        if not isinstance(trainer_cfg, TrainerConfig):
            raise TypeError("config file must define `trainer = TrainerConfig(...)`")
        if args.resume:
            trainer_cfg.resume = True
        return trainer_cfg
    if not args.model or not args.dataset:
        raise SystemExit("either --config or (--model and --dataset) is required")
    model_cfg = get_model_config(args.model)
    if args.optim == "Muon":
        raise not_ported("the Muon optimizer (--optim Muon)", "muon")
    else:
        optim_cfg = AdamWConfig(lr=args.lr, weight_decay=args.weight_decay,
                                max_grad_norm=args.max_grad_norm)
    return TrainerConfig(
        model_cfg=model_cfg,
        dataloader_cfg=DataloaderConfig(
            datasets=[DatasetConfig(anno_path=args.dataset, class_name=args.dataset_type,
                                    chat_template=args.chat_template,
                                    max_length=args.max_length)],
            pack_max_length=args.pack_max_length,
            pack_level=args.pack_level,
            num_workers=args.num_workers,
            tokenize_num_proc=args.tokenize_num_proc,
            cache_dir=args.cache_dir,
        ),
        optim_cfg=optim_cfg,
        lr_cfg=LRConfig(lr_type=args.scheduler_type, warmup_ratio=args.warmup_ratio,
                        lr_min=args.lr_min),
        mesh_cfg=MeshConfig(dp_size=args.dp_size, fsdp_size=args.fsdp_size,
                            tp_size=args.tp_size, sp_size=args.sp_size,
                            ep_size=args.ep_size, remat_policy=args.remat_policy),
        global_batch_rows=args.global_batch_rows,
        micro_batch_rows=args.micro_batch_rows,
        total_steps=args.total_steps,
        epochs=args.epochs,
        load_from=args.load_from or (args.model if "/" in str(args.model) else None),
        tokenizer_path=args.tokenizer_path or args.load_from,
        work_dir=args.work_dir,
        exp_name=args.exp_name,
        checkpoint_interval=args.checkpoint_interval,
        checkpoint_max_keep=args.checkpoint_max_keep,
        snapshot_interval=args.snapshot_interval,
        hf_interval=args.hf_interval,
        resume=args.resume,
        load_model=not args.no_load_model,
        load_optimizer_states=not args.no_load_optimizer_states,
        load_dataset=not args.no_load_dataset,
        seed=args.seed,
    )


def main(argv: Optional[list[str]] = None) -> Trainer:
    args = build_parser().parse_args(argv)
    trainer = Trainer(config_from_args(args), device=args.device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
