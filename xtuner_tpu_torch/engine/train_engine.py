"""TrainEngine: owns the model params and the optimizer state; one
optimizer step over a gradient-accumulation batch (counterpart:
`xtuner_tpu/engine/train_engine.py`).

The constructor takes what `Trainer` passes, as the JAX one does.
`init_random(seed)` draws f32 masters from a `torch.Generator`;
`train_step(batch, step)` takes an (A, B, L) packed batch (with an
optional (A, B, L, nL_moe, K) `rollout_routed_experts`, the recorded
routing an MoE model replays, as JAX's RL loss passes it, and the VLM
keys of JAX's `VLM_BATCH_KEYS`, each with a leading A: InternVL's (T, 3,
S, S) tiles, or Qwen3-VL's patch rows, image-token mask, (3, L) MRoPE
positions and ViT geometry, both as `pixel_values`): A micro-batches,
each one forward/backward with the loss denominator summed over the whole
batch, gradients accumulated in f32; then the global-norm clip, AdamW
(`config/optim.py`), and the JAX package's metrics, plus `dsa_index_loss`
for a DSA model and `mtp_loss` for an MTP model (each summed over the
micro-batches). A step whose grad norm is not finite (or above
`skip_grad_norm_threshold`) is skipped: params and optimizer state stay as
they were.

The noaux router's `e_score_correction_bias` is a buffer: no gradient and
no optimizer state (`config/optim.py::is_buffer`). After a step that was
not skipped, each routed stack's bias moves by `bias_update_speed` toward
uniform load (`module/router.py::update_noaux_bias`) from the step's
expert loads summed over the micro-batches: `moe_layers` from the trunk's
rows, `mtp_layers` from the MTP depths' (summed into one row when the
depths share one layer). `maxvio` averages max / mean load over the trunk's
and the MTP's rows together. `last_expert_load` keeps the step's loads by
stack.

Memory: masters are stored stacked like the JAX tree; the model trains on
per-layer views of them that are autograd leaves, so each layer's gradient
is a tensor of its own and the stacked master is never copied. AdamW
updates the masters in place through those views, one layer at a time. A
stack is any key ending in `layers`, or a vision tower's `blocks`
(InternVL's and Qwen3-VL's) and Qwen3-VL's `deepstack_mergers`, at any
depth of the tree (a VLM's `vision.blocks`, `projector.deepstack_mergers`,
`language.layers`); a hybrid's `pattern` tree gets the same per-period
views for each of its slots.

Freezing: leaves a model's `param_labels` marks "freeze" (InternVL's and
Qwen3-VL's `freeze_vision` / `freeze_projector` / `freeze_language`; under
LoRA every leaf but the adapters) are views that need no gradient and are
no optimizer params: no gradient, no moments, no update, no decay, and out
of the grad norm (JAX's `freeze_stop_gradient` and `optax.set_to_zero`). A
frozen tower on pixels records no autograd graph, so it has no backward
(`model/vision.py`); a frozen language model still runs its backward for
the gradient of its input embeddings, without weight gradients.
QLoRA's NF4 codes stay uint8 and their scales f32 (`ParamSpec.dtype`).

`train_step(batch, step, loss_fn)` takes another loss, as JAX's
`_build_step_fn(loss_fn)` does (the GRPO loss of `rl/trainer.py`); skip,
clip and AdamW are the same, and `reduced_llm_loss` / `consumed_tokens`
are reported only when the loss returns `sum_ce`.

HF checkpoints (a text model, or InternVL's `model/compose.py` with its
`vision_tower.` / `multi_modal_projector.` / `language_model.` keys):
`from_hf` loads f32 masters through `checkpoint/hf.py`
(LoRA adapters drawn from the engine's seeded generator, QLoRA bases
quantized on the device), `save_hf` / `async_save_hf` export them; a LoRA
model is merged first and written with the plain key map (JAX
`save_hf`), a standard HF checkpoint.

Not ported yet: meshes and sharded batches (Queue 1, parallelism).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import not_ported
from ..config.optim import (AdamW, AdamWConfig, LRConfig, _decay_mask, build_lr_schedule,
                            is_buffer)
from ..data_proto import SequenceContext
from ..model.dense import num_layers
from ..module.params import count_params, init_params
from ..module.router import update_noaux_bias
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


# the keys of the vision stacks beside those ending in "layers"
VLM_STACKS = ("blocks", "deepstack_mergers")
# optional batch keys handed into SequenceContext (JAX's VLM_BATCH_KEYS)
VLM_BATCH_KEYS = ("pixel_values", "image_token_mask", "mrope_positions", "vision_segment_ids",
                  "vision_rot_pos", "vision_pos_interp_idx", "vision_pos_interp_w")


def _is_stack(key: str) -> bool:
    return key.endswith("layers") or key in VLM_STACKS


def _leaf_views(master: dict, labels=None):
    """A tree for the model whose layer stacks (at any depth, and each slot
    of a hybrid's `pattern`) are lists of per-layer dicts of leaf views,
    plus [(view, decay)] pairs for the optimizer. Buffers (`is_buffer`) and
    leaves `labels` marks "freeze" (a tree like `master`'s, or one label
    for a whole subtree) are views without grad, outside the pairs."""
    pairs = []

    def child(lab, key):  # a subtree's labels: a tree, or one label for all of it
        return lab[key] if isinstance(lab, dict) else lab

    def views(name, sub, pick, lab):
        if isinstance(sub, dict):
            return {k: views(k, v, pick, child(lab, k)) for k, v in sub.items()}
        if is_buffer(name) or lab == "freeze":
            return pick(sub).detach()
        v = pick(sub).detach().requires_grad_(True)  # shares storage with the master
        pairs.append((v, _decay_mask(sub)))
        return v

    def per_layer(key, sub, lab):
        return [views(key, sub, lambda t, i=i: t[i], lab) for i in range(num_layers(sub))]

    def walk(sub, lab, stacks=False):  # stacks: every key is one (a hybrid's pattern slots)
        tree = {}
        for key, val in sub.items():
            if stacks or _is_stack(key):
                tree[key] = per_layer(key, val, child(lab, key))
            elif isinstance(val, dict):
                tree[key] = walk(val, child(lab, key), key == "pattern")
            else:
                tree[key] = views(key, val, lambda t: t, child(lab, key))
        return tree

    return walk(master, labels), pairs


class TrainEngine:
    """JAX's constructor: `TrainEngine(model_cfg, optim_cfg, lr_cfg,
    mesh_cfg, total_steps)`; the compute dtype and the remat policy come
    from `mesh_cfg` (`parallel/mesh.py`), the device from `device`: the
    card when it is None, and a RuntimeError when there is no card."""

    def __init__(self, model_cfg, optim_cfg: AdamWConfig, lr_cfg: LRConfig,
                 mesh_cfg: MeshConfig, total_steps: int, *, device=None):
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
        router = getattr(model_cfg, "router", None)
        self.noaux_speed = (router.bias_update_speed
                            if getattr(router, "router_type", "") == "noaux" else None)
        self.params = None
        self.optimizer = None
        self.last_expert_load: dict = {}

    @property
    def num_params(self) -> int:
        return count_params(self.specs)

    def init_random(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.load_params(init_params(self.specs, gen, self.device, torch.float32))

    def from_hf(self, hf_path: str, seed: int = 0) -> None:
        """f32 masters from an HF safetensors checkpoint
        (`checkpoint/hf.py`), straight onto the engine's device, and a
        fresh optimizer state; leaves the checkpoint lacks (LoRA adapters)
        are drawn from a generator seeded with `seed`."""
        from ..checkpoint.hf import load_hf_checkpoint

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.load_params(load_hf_checkpoint(hf_path, self.specs, self.model.hf_key_map(),
                                            self.device, torch.float32, generator=gen))

    def _export(self):
        """(params, key map) of an HF export: a LoRA model merged and
        mapped plainly (JAX `save_hf`)."""
        if getattr(self.model_cfg, "lora_cfg", None) is not None:
            return (self.model.merge_lora(self.params),
                    self.model.plain_config().build().hf_key_map())
        return self.params, self.model.hf_key_map()

    def save_hf(self, hf_path: str) -> None:
        from ..checkpoint.hf import save_hf_checkpoint

        save_hf_checkpoint(hf_path, *self._export(), self.model_cfg)

    def async_save_hf(self, hf_path: str):
        """The masters (merged under LoRA) snapshotted to the host, written
        on a background thread; returns a handle with `.join()` and
        `.done`."""
        from ..checkpoint.hf import async_save_hf_checkpoint

        return async_save_hf_checkpoint(hf_path, *self._export(), self.model_cfg)

    def load_params(self, params: dict) -> None:
        """Take f32 masters (e.g. from `module/params.py::params_from_numpy`)
        and start a fresh optimizer state."""
        self.params = params
        labels = (self.model.param_labels(self.specs)
                  if hasattr(self.model, "param_labels") else None)
        self._train_tree, pairs = _leaf_views(params, labels)
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

    def seq_ctx(self, mb: dict) -> SequenceContext:
        """A micro-batch's SequenceContext: ids, segments, positions, the
        replayed routing and the VLM keys it holds."""
        return SequenceContext(
            mb["input_ids"], mb["segment_ids"], mb["position_ids"],
            mb.get("rollout_routed_experts"),
            **{k: mb[k] for k in VLM_BATCH_KEYS if k in mb})

    def default_loss(self, params, mb: dict, denom) -> tuple:
        """The SFT loss of `train_step`: `model.loss` with the calibrated CE
        -> (total loss, its metrics: sum_ce, num_tokens and the model's
        extras)."""
        out = self.model.loss(params, self.seq_ctx(mb), mb["shifted_labels"],
                              mb["loss_weights"], denom, compute_dtype=self.compute_dtype,
                              remat=self.remat)
        mets = {"sum_ce": out.sum_ce.detach(), "num_tokens": out.num_tokens}
        if out.expert_load is not None:
            mets["expert_load"] = out.expert_load.float()
        if out.mtp_expert_load is not None:
            mets["mtp_expert_load"] = out.mtp_expert_load.float()
        if out.dsa_index_loss is not None:
            mets["dsa_index_loss"] = out.dsa_index_loss.detach()
        if out.mtp_loss is not None:
            mets["mtp_loss"] = out.mtp_loss.detach()
        return out.total_loss(), mets

    def train_step(self, batch: dict, step: int, loss_fn=None) -> dict:
        """One optimizer step over a grad-accum batch of (A, B, L) arrays.
        `loss_fn(params, mb, denom) -> (loss, dict of metrics)` replaces
        the SFT loss (JAX `_build_step_fn(loss_fn)`): `params` is the
        engine's training tree, `mb` a micro-batch's tensors on the device,
        `denom` the batch's summed `loss_weights`; each metric is summed
        over the micro-batches."""
        loss_fn = loss_fn or self.default_loss
        dev = self._to_device(batch)
        denom = dev["loss_weights"].float().sum()
        for p in self._leaves:
            p.grad = None
        sums: dict = {}
        for a in range(dev["input_ids"].shape[0]):
            mb = {k: v[a] for k, v in dev.items()}
            total, mets = loss_fn(self._train_tree, mb, denom)
            total.backward()
            mets = {"total_loss": total, **mets}
            for k, v in mets.items():
                v = v.detach() if torch.is_tensor(v) else v
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
        # the routed stacks' loads: the trunk's rows, then the MTP depths'
        self.last_expert_load = {stack: sums.pop(key) for stack, key in
                                 (("moe_layers", "expert_load"),
                                  ("mtp_layers", "mtp_expert_load")) if key in sums}
        if ok and self.noaux_speed is not None:
            for stack, load in self.last_expert_load.items():
                bias = self.params[stack]["router"]["e_score_correction_bias"]
                if load.shape[0] != bias.shape[0]:  # depths sharing one MTP layer
                    load = load.sum(dim=0, keepdim=True)
                update_noaux_bias(bias, load, self.noaux_speed)

        metrics = {"total_loss": float(sums.pop("total_loss"))}
        if self.last_expert_load:
            load = torch.cat(list(self.last_expert_load.values()))
            metrics["maxvio"] = float(
                (load.max(dim=-1).values / load.mean(dim=-1).clamp(min=1e-6)).mean())
        ce = {}
        if "sum_ce" in sums:  # JAX reports these only when the loss returns sum_ce
            n_tok = int(sums.pop("num_tokens", 1))
            ce = {"reduced_llm_loss": float(sums.pop("sum_ce")) / max(n_tok, 1),
                  "consumed_tokens": n_tok}
        metrics.update({k: float(v) for k, v in sums.items()})
        metrics.update(ce)
        metrics.update(grad_norm=norm, lr=float(self.lr_schedule(step)), skipped=int(not ok))
        return metrics
