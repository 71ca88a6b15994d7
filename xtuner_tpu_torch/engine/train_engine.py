"""TrainEngine: owns the model params and the optimizer state; one
optimizer step over a gradient-accumulation batch (counterpart:
`xtuner_tpu/engine/train_engine.py`).

The constructor takes what `Trainer` passes, as the JAX one does.
`init_random(seed)` draws f32 masters from a `torch.Generator`;
`train_step(batch, step)` takes an (A, B, L) packed batch: A micro-batches,
each one forward/backward with the loss denominator summed over the whole
batch, gradients accumulated in f32; then the global-norm clip, AdamW
(`config/optim.py`), and the JAX package's metrics, plus `dsa_index_loss`
(summed over the micro-batches) for a DSA model. A step whose grad norm is
not finite (or above `skip_grad_norm_threshold`) is skipped: params and
optimizer state stay as they were.

Memory: masters are stored stacked like the JAX tree; the model trains on
per-layer views of them that are autograd leaves, so each layer's gradient
is a tensor of its own and the stacked master is never copied. AdamW
updates the masters in place through those views.

Not ported yet: the noaux router's post-step bias update ([moe]), LoRA
freezing ([lora]), custom loss functions, meshes and sharded batches
(Queue 1, parallelism), HF load and save ([serve-rest]).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import not_ported
from ..config.optim import AdamW, AdamWConfig, LRConfig, _decay_mask, build_lr_schedule
from ..data_proto import SequenceContext
from ..model.dense import num_layers
from ..module.params import count_params, init_params, tree_map
from ..parallel.mesh import MeshConfig


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. A missing card raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is False. The port "
                           "trains on the card; pass device='cpu' (the sft CLI: "
                           "--device cpu) to run on the CPU")
    return dev


def _leaf_views(master: dict):
    """A tree for the model whose layer stacks are lists of per-layer dicts
    of leaf views, plus [(view, decay)] pairs for the optimizer."""
    pairs = []

    def leaf(t, decay):
        v = t.detach().requires_grad_(True)  # shares storage with the master
        pairs.append((v, decay))
        return v

    tree = {}
    for key, sub in master.items():
        if key.endswith("layers"):
            tree[key] = [tree_map(lambda t, i=i: leaf(t[i], _decay_mask(t)), sub)
                         for i in range(num_layers(sub))]
        else:
            tree[key] = tree_map(lambda t: leaf(t, _decay_mask(t)), sub)
    return tree, pairs


class TrainEngine:
    """JAX's constructor: `TrainEngine(model_cfg, optim_cfg, lr_cfg,
    mesh_cfg, total_steps)`; the compute dtype and the remat policy come
    from `mesh_cfg` (`parallel/mesh.py`), the device from `device`: the
    card when it is None, and a RuntimeError when there is no card."""

    def __init__(self, model_cfg, optim_cfg: AdamWConfig, lr_cfg: LRConfig,
                 mesh_cfg: MeshConfig, total_steps: int, *, device=None):
        router = getattr(model_cfg, "router", None)
        if router is not None and getattr(router, "router_type", "") == "noaux":
            raise not_ported("the noaux router's post-step bias update", "moe")
        if getattr(model_cfg, "lora_cfg", None) is not None:
            raise not_ported("LoRA training", "lora")
        if getattr(optim_cfg, "type", "adamw") != "adamw":
            raise not_ported(f"optimizer {optim_cfg.type!r}", "muon")
        mesh_cfg.check_ported()
        self.model_cfg = model_cfg
        self.optim_cfg = optim_cfg
        self.mesh_cfg = mesh_cfg
        self.model = model_cfg.build()
        self.specs = self.model.param_specs()
        self.compute_dtype = mesh_cfg.compute_dtype
        self.remat = mesh_cfg.remat
        self.device = resolve_device(device)
        self.lr_schedule = build_lr_schedule(optim_cfg, lr_cfg, total_steps)
        self.params = None
        self.optimizer = None

    @property
    def num_params(self) -> int:
        return count_params(self.specs)

    def init_random(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.load_params(init_params(self.specs, gen, self.device, torch.float32))

    def load_params(self, params: dict) -> None:
        """Take f32 masters (e.g. from `module/params.py::params_from_numpy`)
        and start a fresh optimizer state."""
        self.params = params
        self._train_tree, pairs = _leaf_views(params)
        self._leaves = [v for v, _ in pairs]
        self.optimizer = AdamW(self._leaves, [d for _, d in pairs], self.optim_cfg,
                               self.lr_schedule)

    @property
    def opt_state(self) -> dict:
        """The AdamW state (`config/optim.py::AdamW.state_dict`)."""
        return self.optimizer.state_dict()

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def train_step(self, batch: dict, step: int) -> dict:
        """One optimizer step over a grad-accum batch of (A, B, L) arrays."""
        dev = self._to_device(batch)
        denom = dev["loss_weights"].float().sum()
        for p in self._leaves:
            p.grad = None
        sums: dict = {}
        for a in range(dev["input_ids"].shape[0]):
            mb = {k: v[a] for k, v in dev.items()}
            seq_ctx = SequenceContext(mb["input_ids"], mb["segment_ids"], mb["position_ids"])
            out = self.model.loss(self._train_tree, seq_ctx, mb["shifted_labels"],
                                  mb["loss_weights"], denom, compute_dtype=self.compute_dtype,
                                  remat=self.remat)
            total = out.total_loss()
            total.backward()
            mets = {"total_loss": total.detach(), "sum_ce": out.sum_ce.detach(),
                    "num_tokens": out.num_tokens}
            if out.expert_load is not None:
                mets["expert_load"] = out.expert_load.float()
            if out.dsa_index_loss is not None:
                mets["dsa_index_loss"] = out.dsa_index_loss.detach()
            for k, v in mets.items():
                sums[k] = sums[k] + v if k in sums else v

        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._leaves]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        norm = float(grad_norm)  # the one host read of the step: skip or update
        ok = np.isfinite(norm)
        thr = self.optim_cfg.skip_grad_norm_threshold
        if thr is not None:
            ok = ok and norm < thr
        if ok:
            scale = min(1.0, self.optim_cfg.max_grad_norm / (norm + 1e-6))
            if scale < 1.0:
                torch._foreach_mul_(grads, scale)
            self.optimizer.step(grads)
        for p in self._leaves:
            p.grad = None

        metrics = {"total_loss": float(sums["total_loss"])}
        if "expert_load" in sums:
            load = sums["expert_load"]
            metrics["maxvio"] = float(
                (load.max(dim=-1).values / load.mean(dim=-1).clamp(min=1e-6)).mean())
        if "dsa_index_loss" in sums:  # the port's tracker key for the indexer loss
            metrics["dsa_index_loss"] = float(sums["dsa_index_loss"])
        n_tok = int(sums["num_tokens"])
        metrics["reduced_llm_loss"] = float(sums["sum_ce"]) / max(n_tok, 1)
        metrics["consumed_tokens"] = n_tok
        metrics.update(grad_norm=norm, lr=float(self.lr_schedule(step)), skipped=int(not ok))
        return metrics
