"""Dataset and dataloader configs (counterpart:
`xtuner_tpu/datasets/config.py`): the same fields and defaults as
dataclasses, and `DataloaderConfig.build`, which assembles jsonl datasets
-> packer -> sampler -> `Dataloader` as the JAX one does.

The text classes ("openai_sft", "pretrain") are ported; "internvl" and
"qwen3_vl" raise ([trainer-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Optional

from .. import not_ported
from .dataloader import Dataloader
from .jsonl import JsonlDataset
from .packing import HardPackDataset, SoftPackDataset
from .sampler import LengthGroupedSampler, ParallelSampler
from .tokenize_fns import OpenaiSFTTokenizeFn, PretrainTokenizeFn


@dataclass
class DatasetConfig:
    anno_path: str  # jsonl file or directory of jsonl files
    name: str = ""
    sample_ratio: float = 1.0
    class_name: Literal["openai_sft", "pretrain", "internvl", "qwen3_vl"] = "openai_sft"
    chat_template: str = "qwen"
    max_length: Optional[int] = None


@dataclass
class DataloaderConfig:
    datasets: list[DatasetConfig]
    pack_max_length: int = 16384
    pack_level: Literal["soft", "hard", "none"] = "soft"
    pack_balance: Literal["none", "flops"] = "none"
    num_workers: int = 0  # host prefetch threads (0 = synchronous)
    tokenize_num_proc: int = 0  # token-count processes; 0 = auto
    cache_dir: Optional[str] = None
    loss_reduction: Literal["token", "sample", "square"] = "token"
    # pad fill for unused pack slots; None -> resolved from the tokenizer by
    # Trainer._reconcile_config
    pad_token_id: Optional[int] = None
    seed: int = 0
    shuffle: bool = True
    length_grouped: bool = False
    # VLM fields (kept so configs translate; a value > 0 raises)
    max_tiles: int = 0
    tokens_per_tile: int = 256
    image_size: int = 448
    image_max_num: int = 12
    max_patches: int = 0
    image_min_pixels: int = 65536
    image_max_pixels: int = 16777216
    vision_patch_size: int = 16
    vision_merge_size: int = 2
    vision_num_grid_per_side: int = 48

    def build(self, tokenizer, global_batch_rows: int, micro_batch_rows: int) -> Dataloader:
        datasets = []
        for ds_cfg in self.datasets:
            path = Path(ds_cfg.anno_path)
            files = sorted(path.glob("*.jsonl")) if path.is_dir() else [path]
            for f in files:
                if ds_cfg.class_name == "openai_sft":
                    fn = OpenaiSFTTokenizeFn(tokenizer, ds_cfg.chat_template, ds_cfg.max_length)
                elif ds_cfg.class_name == "pretrain":
                    fn = PretrainTokenizeFn(tokenizer, max_length=ds_cfg.max_length)
                else:
                    raise not_ported(f"the {ds_cfg.class_name!r} dataset class", "trainer-rest")
                datasets.append(
                    JsonlDataset(f, fn, cache_dir=self.cache_dir,
                                 sample_ratio=ds_cfg.sample_ratio, name=ds_cfg.name or f.stem,
                                 num_proc=self.tokenize_num_proc)
                )
        if not datasets:
            raise ValueError("No datasets found")
        if self.pack_level == "hard":
            packed = HardPackDataset(datasets, self.pack_max_length, seed=self.seed)
        else:
            packed = SoftPackDataset(datasets, self.pack_max_length, seed=self.seed,
                                     balance=self.pack_balance)
        if self.length_grouped:
            # group by per-pack attention FLOPs when available, else tokens
            if getattr(packed, "pack_flops", None):
                pack_lens = packed.pack_flops
            elif hasattr(packed, "packs"):
                pack_lens = [sum(min(datasets[di].num_tokens[si], self.pack_max_length)
                                 for di, si in pack) for pack in packed.packs]
            else:
                pack_lens = [self.pack_max_length] * len(packed)
            sampler = LengthGroupedSampler(len(packed), pack_lens,
                                           group_size=global_batch_rows * 8, seed=self.seed)
        else:
            sampler = ParallelSampler(len(packed), seed=self.seed, shuffle=self.shuffle)
        return Dataloader(
            packed, sampler, pack_max_length=self.pack_max_length,
            global_batch_rows=global_batch_rows, micro_batch_rows=micro_batch_rows,
            loss_reduction=self.loss_reduction, num_workers=self.num_workers,
            max_tiles=self.max_tiles, max_patches=self.max_patches,
            pad_token_id=self.pad_token_id or 0,
        )
