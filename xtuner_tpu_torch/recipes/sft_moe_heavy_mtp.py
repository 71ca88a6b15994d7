"""moe_heavy SFT with one multi-token-prediction layer on one card:
`recipes/sft_moe_heavy.py` (`bench.py`'s primary configuration at full
width and depth) with `mtp_num_layers=1`, nothing else changed.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_moe_heavy_mtp.py

The MTP depth is one more MoE layer (its attention, 16 experts and
router) with the fuse projection (2048 x 1024) and two norms: 46.1 M
params over moe_heavy's 596.2 M (642.3 M in all). It fuses the trunk's last hidden state with
the next token's embedding and predicts the token after it through the
tied head, so the fused CE runs twice a step; `mtp_loss` is 0.3 x that
CE. The trunk's forward is moe_heavy's: its step-1 CE is the same.
"""

import dataclasses
import runpy
from pathlib import Path

_BASE = runpy.run_path(str(Path(__file__).resolve().with_name("sft_moe_heavy.py")))["trainer"]

trainer = dataclasses.replace(
    _BASE, model_cfg=dataclasses.replace(_BASE.model_cfg, mtp_num_layers=1),
    exp_name="sft_moe_heavy_mtp")
