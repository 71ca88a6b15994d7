"""GRPO colocate RL trainer (counterpart: `xtuner_tpu/rl/trainer.py`; the
config is a dataclass).

The policy that rolls out is the one being trained, in one process: the
rollout is `model/generate.py::generate` on the engine's params, so the
"weight sync" is passing `engine.params` to it. A step: sample prompts ->
G rollouts per prompt in one batched `generate` (prefilled once per
prompt, with logprobs, and with R3 the MoE routing) -> judge rewards ->
group advantages -> replay buffer -> pack (B, L) rows -> teacher-forced
logprobs where the loss needs them (the frozen reference's for the KL;
the current policy's for rollout-IS) -> one `TrainEngine.train_step`
with the GRPO (or OREAL) loss, through its `loss_fn` hook.

The frozen reference is `compute_copy` of the initial params: layer
stacks, embedding and head in the compute dtype, the final norm in f32.
Every forward casts those leaves to the compute dtype before it reads
them, so it gives the logprobs JAX's f32 copy gives (tests/test_torch_rl.py
shows it), in half the memory of an f32 copy. `debug_rollout_capture`
writes every produced batch under <work_dir>/rollout_traces/,
`debug_rollout_replay_from` trains on captured batches instead of
generating. The evaluator and the SFT interleave (one SFT step on the
same engine every `sft_interval` RL steps) are ported.

The tracker has JAX's keys and, beside them, the step's split:
`rollout_time`, `logprob_time` (teacher-forced logprobs), `train_time`,
`rollout_tokens` (response tokens generated), and on a card the peak
memory of the rollout and of the rest of the step (`rollout_peak_gib`,
`step_peak_gib`).

Not ported yet: `load_from` ([serve-rest]); mesh axes above 1
([parallelism]).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .. import not_ported
from ..config.optim import AdamWConfig, LRConfig
from ..data_proto.templates import get_chat_template
from ..engine.train_engine import TrainEngine, resolve_device
from ..loss.ce_loss import per_token_logprobs
from ..model.generate import GenerateConfig, compute_copy, generate
from ..parallel.mesh import MeshConfig
from ..utils.logger import get_logger, log_file_handler
from ..writer import JsonlWriter
from .advantage import compute_advantage
from .evaluator import Evaluator, EvaluatorConfig
from .grpo_loss import GRPOLossConfig, OREALLossConfig, grpo_loss, oreal_loss
from .judger import JUDGER_MAP
from .replay_buffer import ReplayBuffer, SampleGroup
from .trace import RolloutTraceStore

logger = get_logger()


@dataclass
class RLTrainerConfig:
    model_cfg: Any
    prompts_path: str  # jsonl: {"messages": [...] | "prompt": str, "label": ...}
    optim_cfg: Any = field(default_factory=lambda: AdamWConfig(lr=1e-6))
    lr_cfg: LRConfig = field(default_factory=lambda: LRConfig(lr_type="constant",
                                                              warmup_ratio=0.0))
    mesh_cfg: MeshConfig = field(default_factory=MeshConfig)
    loss_cfg: GRPOLossConfig = field(default_factory=GRPOLossConfig)
    gen_cfg: GenerateConfig = field(
        default_factory=lambda: GenerateConfig(max_new_tokens=64, temperature=1.0))
    group_size: int = 8  # rollouts per prompt (GRPO group)
    prompts_per_step: int = 4
    total_steps: int = 10
    max_prompt_length: int = 256
    judger: str = "gsm8k"
    advantage: str = "grpo"
    chat_template: str = "qwen"
    load_from: Optional[str] = None  # [serve-rest]
    tokenizer_path: Optional[str] = None
    work_dir: str = "work_dirs"
    exp_name: str = "rl"
    seed: int = 0
    max_staleness: Optional[int] = None
    eval_cfg: Optional[EvaluatorConfig] = None
    # R3 rollout-routing replay (MoE): train with the rollout's expert ids
    rollout_routing_replay: bool = False
    # capture writes every produced batch to <work_dir>/rollout_traces/;
    # replay_from trains on captured batches instead of generating
    debug_rollout_capture: bool = False
    debug_rollout_replay_from: Optional[str] = None
    # mixed RL + SFT: every `sft_interval` RL steps one SFT step from this
    # dataloader (datasets.config.DataloaderConfig) on the same engine
    sft_dataloader_cfg: Optional[Any] = None
    sft_interval: int = 0  # 0 disables

    def check_ported(self) -> None:
        self.mesh_cfg.check_ported()
        if self.load_from:
            raise not_ported("loading an HF checkpoint (load_from)", "serve-rest")

    def build(self, device=None) -> "RLColocateTrainer":
        return RLColocateTrainer(self, device=device)


class RLColocateTrainer:
    """`RLColocateTrainer(cfg, device=None)`: on the card unless `device`
    names another; with no card and no device given it raises."""

    def __init__(self, cfg: RLTrainerConfig, device=None):
        cfg.check_ported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.work_dir = Path(cfg.work_dir) / cfg.exp_name
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._log_handler = log_file_handler(str(self.work_dir / "rank0.log"))
        self.tokenizer = self._build_tokenizer()
        self.prompts = [json.loads(x) for x in Path(cfg.prompts_path).read_text().splitlines()
                        if x]
        self.engine = TrainEngine(cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg,
                                  cfg.total_steps, device=self.device)
        self.engine.init_random(cfg.seed)
        logger.info(f"model: {self.engine.num_params / 1e6:.1f}M params | device "
                    f"{self.device} | compute {self.engine.compute_dtype} | remat "
                    f"{self.engine.remat} | total_steps {cfg.total_steps}")
        # the frozen reference policy of the KL penalty
        self.ref_params = None
        if cfg.loss_cfg.kl_coef > 0.0:
            self.ref_params = compute_copy(self.engine.params, self.engine.compute_dtype)
        self.judger = JUDGER_MAP[cfg.judger]()
        self.replay_buffer = ReplayBuffer(max_staleness=cfg.max_staleness)
        self.writer = JsonlWriter(self.work_dir)
        self.rng = np.random.default_rng(cfg.seed)
        self.gen_rng = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        self.evaluator = None
        if cfg.eval_cfg is not None:
            self.evaluator = Evaluator(cfg.eval_cfg, self.judger, self._eval_generate)
        self._sft_iter = None
        self._sft_dataloader = None
        if cfg.sft_interval and cfg.sft_dataloader_cfg is not None:
            self._sft_dataloader = cfg.sft_dataloader_cfg.build(
                self.tokenizer, global_batch_rows=1, micro_batch_rows=1)

    def _build_tokenizer(self):
        if self.cfg.tokenizer_path:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(self.cfg.tokenizer_path, trust_remote_code=True)
        from ..train.toy_tokenizer import UTF8ByteTokenizer

        return UTF8ByteTokenizer()

    @property
    def _eos(self) -> int:
        return self.cfg.gen_cfg.eos_token_id or self.cfg.model_cfg.eos_token_id

    # ------------------------------------------------------------------
    def _encode_prompt(self, item: dict) -> list[int]:
        """Each history turn through ITS role's template; the user template
        ends with the assistant generation prompt. Pre-tokenized items
        (`datasets/rl_tokenize.py`) pass their `prompt_ids`."""
        if "prompt_ids" in item:
            return list(item["prompt_ids"])[-self.cfg.max_prompt_length:]
        template = get_chat_template(self.cfg.chat_template)
        msgs = item["messages"] if "messages" in item else [
            {"role": "user", "content": item["prompt"]}]
        ids: list[int] = []
        for m in msgs:
            role, content = m["role"], m.get("content", "")
            if role == "system":
                text = template.system.format(system=content)
            elif role == "assistant":
                text = template.assistant.format(assistant=content)
            else:  # user / tool
                text = template.user.format(user=content)
            ids.extend(self.tokenizer.encode(text, add_special_tokens=False))
        return ids[-self.cfg.max_prompt_length:]

    def _generate(self, prompt_arr: np.ndarray, **kw) -> dict:
        return generate(self.engine.model, self.engine.params, prompt_arr, self.cfg.gen_cfg,
                        generator=self.gen_rng, compute_dtype=self.engine.compute_dtype,
                        pad_token_id=self.pad_id, **kw)

    def _eval_generate(self, items: list[dict], n: int) -> list[list[str]]:
        """The evaluator's binding: n sampled responses per eval prompt."""
        out_texts = []
        for item in items:
            prompt = self._encode_prompt(item)
            prompt_arr = np.full((n, self.cfg.max_prompt_length), self.pad_id, np.int32)
            prompt_arr[:, -len(prompt):] = prompt
            out = self._generate(prompt_arr)
            texts = []
            for gi in range(n):
                resp = out["generated"][gi].tolist()
                if self._eos in resp:
                    resp = resp[:resp.index(self._eos)]
                texts.append(self.tokenizer.decode(resp))
            out_texts.append(texts)
        return out_texts

    def produce_batch(self, policy_version: int) -> list[SampleGroup]:
        """Rollouts, rewards and advantages: every prompt group in ONE
        batched `generate` call, each prompt prefilled once."""
        cfg = self.cfg
        idxs = self.rng.choice(len(self.prompts), cfg.prompts_per_step, replace=False)
        items = [self.prompts[int(pi)] for pi in idxs]
        prompts = [self._encode_prompt(item) for item in items]
        g = cfg.group_size
        prompt_arr = np.full((len(items) * g, cfg.max_prompt_length), self.pad_id, np.int32)
        for i, prompt in enumerate(prompts):
            prompt_arr[i * g:(i + 1) * g, -len(prompt):] = prompt  # left padding
        out = self._generate(prompt_arr, return_logprobs=True,
                             record_routing=cfg.rollout_routing_replay, prompt_group_size=g)
        eos = self._eos
        groups = []
        for i, (pi, item, prompt) in enumerate(zip(idxs, items, prompts)):
            samples, rewards = [], []
            for gi in range(g):
                row = i * g + gi
                resp = out["generated"][row].tolist()
                n_resp = resp.index(eos) + 1 if eos in resp else len(resp)
                text = self.tokenizer.decode(resp[:n_resp])
                reward = self.judger.judge(text, item.get("label") or item.get("answer"))
                rewards.append(reward)
                samples.append({"prompt_ids": prompt, "response_ids": resp[:n_resp],
                                "logprobs": out["logprobs"][row][:n_resp], "reward": reward})
                if "routed_experts" in out:
                    samples[-1]["routed_experts"] = out["routed_experts"][row][:n_resp]
            advs = compute_advantage(np.asarray(rewards), cfg.advantage)
            for s, a in zip(samples, advs):
                s["advantage"] = float(a)
            groups.append(SampleGroup(prompt_id=int(pi), samples=samples,
                                      policy_version=policy_version,
                                      meta={"mean_reward": float(np.mean(rewards))}))
        return groups

    # ------------------------------------------------------------------
    def _pack(self, groups: list[SampleGroup]) -> dict[str, np.ndarray]:
        """Samples -> (1, B, L) arrays for one optimizer step, L the prompt
        and response bound rounded up to 128 (one shape every step)."""
        rows = [s for g in groups for s in g.samples]
        bound = self.cfg.max_prompt_length + self.cfg.gen_cfg.max_new_tokens
        max_len = -(-bound // 128) * 128
        b = len(rows)
        ids = np.zeros((b, max_len), np.int32)
        seg = np.zeros((b, max_len), np.int32)
        pos = np.zeros((b, max_len), np.int32)
        labels = np.full((b, max_len), -100, np.int32)
        old_lp = np.zeros((b, max_len), np.float32)
        adv = np.zeros((b, max_len), np.float32)
        routed = None
        route_shape = next((np.asarray(s["routed_experts"]).shape[1:]
                            for s in rows if "routed_experts" in s), None)
        if route_shape is not None:
            # -1 = no replay here: prompt and pad positions route afresh
            routed = np.full((b, max_len, *route_shape), -1, np.int32)
        for bi, s in enumerate(rows):
            p, r = list(s["prompt_ids"]), list(s["response_ids"])
            n = len(p) + len(r)
            ids[bi, :n] = p + r
            seg[bi, :n] = 1
            pos[bi, :n] = np.arange(n)
            # shifted: position t supervises token t+1; responses start at len(p)
            t = np.arange(len(r)) + len(p) - 1
            labels[bi, t] = r
            old_lp[bi, t] = np.asarray(s["logprobs"], np.float32)[:len(r)]
            adv[bi, t] = s["advantage"]
            if routed is not None and "routed_experts" in s:
                # the forward that sampled token j routed input position len(p)+j-1
                routed[bi, t] = np.asarray(s["routed_experts"])[:len(r)]
        mask = (labels != -100).astype(np.float32)
        out = {
            "input_ids": ids[None], "segment_ids": seg[None], "position_ids": pos[None],
            "shifted_labels": labels[None], "loss_weights": mask[None],
            "old_logprobs": old_lp[None], "advantages": adv[None],
            # whole-batch pos/neg token counts for OREAL's global calibration
            "global_pos": np.asarray([((labels != -100) & (adv > 0)).sum()], np.float32),
            "global_neg": np.asarray([((labels != -100) & (adv <= 0)).sum()], np.float32),
        }
        if routed is not None:
            out["rollout_routed_experts"] = routed[None]
        return out

    def _rl_loss_fn(self):
        eng = self.engine
        model, dtype, remat = eng.model, eng.compute_dtype, eng.remat
        loss_cfg = self.cfg.loss_cfg
        chunk = self.cfg.model_cfg.lm_loss_cfg.chunk_size

        def loss_fn(params, mb, denom):
            hidden = model.forward(params, eng.seq_ctx(mb), compute_dtype=dtype, remat=remat)
            w = model.lm_head_weight(params).to(dtype)
            logps = per_token_logprobs(hidden, w, mb["shifted_labels"], chunk)
            mask = mb["shifted_labels"] != -100
            if isinstance(loss_cfg, OREALLossConfig):
                return oreal_loss(logps, mb["old_logprobs"], mb["advantages"], mask, loss_cfg,
                                  ref_logprobs=mb.get("ref_logprobs"), global_denom=denom,
                                  global_pos=mb.get("global_pos"),
                                  global_neg=mb.get("global_neg"))
            return grpo_loss(logps, mb["old_logprobs"], mb["advantages"], mask, loss_cfg,
                             ref_logprobs=mb.get("ref_logprobs"), global_denom=denom,
                             rollout_logprobs=mb.get("rollout_logprobs"))

        return loss_fn

    @torch.no_grad()
    def _compute_teacher_forced_logprobs(self, params, batch: dict) -> np.ndarray:
        """Per-token logprobs of the packed batch under `params` (the frozen
        reference, or the current policy for rollout-IS), routing afresh."""
        from ..data_proto import SequenceContext

        eng = self.engine
        a, b, l = batch["input_ids"].shape
        t = {k: torch.as_tensor(batch[k].reshape(a * b, l)).to(self.device)
             for k in ("input_ids", "segment_ids", "position_ids", "shifted_labels")}
        seq_ctx = SequenceContext(t["input_ids"], t["segment_ids"], t["position_ids"])
        hidden = eng.model.forward(params, seq_ctx, compute_dtype=eng.compute_dtype,
                                   remat="none")
        w = eng.model.lm_head_weight(params).to(eng.compute_dtype)
        lps = per_token_logprobs(hidden, w, t["shifted_labels"],
                                 self.cfg.model_cfg.lm_loss_cfg.chunk_size)
        return lps.float().cpu().numpy().reshape(a, b, l)

    def _compute_ref_logprobs(self, batch: dict) -> np.ndarray:
        return self._compute_teacher_forced_logprobs(self.ref_params, batch)

    def _maybe_add_rollout_is_inputs(self, batch: dict) -> None:
        """With rollout-IS on, the packed `old_logprobs` (the decode's)
        become `rollout_logprobs` and the training policy's are recomputed
        teacher-forced with the current params."""
        if self.cfg.loss_cfg.rollout_is is None:
            return
        batch["rollout_logprobs"] = batch["old_logprobs"]
        batch["old_logprobs"] = self._compute_teacher_forced_logprobs(self.engine.params, batch)

    # ------------------------------------------------------------------
    def _maybe_sft_step(self, step: int) -> Optional[dict]:
        """Every `sft_interval` RL steps one SFT step (the default CE loss)
        on the same engine and optimizer; the dataloader cycles epochs."""
        cfg = self.cfg
        if not cfg.sft_interval or self._sft_dataloader is None or step % cfg.sft_interval:
            return None
        if self._sft_iter is None:
            self._sft_iter = iter(self._sft_dataloader)
        try:
            batch = next(self._sft_iter)
        except StopIteration:
            self._sft_iter = iter(self._sft_dataloader)
            batch = next(self._sft_iter)
        metrics = self.engine.train_step(batch, step)
        logger.info(f"SFT interleave at RL step {step}: "
                    f"loss {metrics.get('reduced_llm_loss', float('nan')):.4f}")
        return metrics

    def _peak_gib(self, key: str, out: dict) -> None:
        """On a card: `out[key]` = the peak GiB since the last call, and a
        fresh peak from here."""
        if self.device.type != "cuda":
            return
        torch.cuda.synchronize(self.device)
        if key:
            out[key] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        torch.cuda.reset_peak_memory_stats(self.device)

    def fit(self) -> None:
        cfg = self.cfg
        replay = RolloutTraceStore(cfg.debug_rollout_replay_from) \
            if cfg.debug_rollout_replay_from else None
        trace = RolloutTraceStore(self.work_dir) if cfg.debug_rollout_capture else None
        loss_fn = self._rl_loss_fn()
        try:
            for step in range(1, cfg.total_steps + 1):
                t0 = time.time()
                extra: dict = {}
                self._peak_gib("", extra)
                if replay is not None:
                    groups = replay.load_groups(step)
                    if not groups:
                        logger.info(f"debug replay: no captured rollout for step {step}; "
                                    "stopping")
                        break
                else:
                    groups = self.produce_batch(policy_version=step)
                if trace is not None:
                    trace.record(step, groups, tokenizer=self.tokenizer)
                for g in groups:
                    self.replay_buffer.put(g)
                self.replay_buffer.maybe_expire(step)
                train_groups = self.replay_buffer.get(cfg.prompts_per_step)
                t_roll = time.time() - t0
                self._peak_gib("rollout_peak_gib", extra)
                t1 = time.time()
                batch = self._pack(train_groups)
                self._maybe_add_rollout_is_inputs(batch)
                if self.ref_params is not None:
                    batch["ref_logprobs"] = self._compute_ref_logprobs(batch)
                t_lp = time.time() - t1
                t2 = time.time()
                metrics = self.engine.train_step(batch, step, loss_fn)
                t_train = time.time() - t2
                self._peak_gib("step_peak_gib", extra)
                mean_reward = float(np.mean([g.meta["mean_reward"] for g in train_groups]))
                n_tok = sum(len(s["response_ids"]) for g in train_groups for s in g.samples)
                step_time = time.time() - t0
                kl_part = f"kl {metrics['kl']:.5f} " if "kl" in metrics else ""
                logger.info(
                    f"RL Step {step}/{cfg.total_steps} reward {mean_reward:.3f} "
                    f"pg_loss {metrics['pg_loss']:.4f} ratio {metrics['ratio_mean']:.3f} "
                    f"clip_frac {metrics['clip_frac']:.3f} {kl_part}"
                    f"grad_norm {metrics['grad_norm']:.3f} "
                    f"rollout {t_roll:.1f}s step {step_time:.1f}s")
                extra.update(rollout_tokens=n_tok, logprob_time=t_lp, train_time=t_train)
                self.writer.add_scalars({**metrics, "mean_reward": mean_reward,
                                         "rollout_time": t_roll, "step_time": step_time,
                                         **extra}, step)
                sft_mets = self._maybe_sft_step(step)
                if sft_mets is not None:
                    self.writer.add_scalars({f"sft/{k}": v for k, v in sft_mets.items()}, step)
                if (self.evaluator is not None and cfg.eval_cfg.eval_interval
                        and step % cfg.eval_cfg.eval_interval == 0):
                    self.writer.add_scalars(self.evaluator.run(), step)
            if self.evaluator is not None:
                self.writer.add_scalars(self.evaluator.run(), cfg.total_steps)
        finally:
            self.writer.close()
            if self._sft_dataloader is not None:
                self._sft_dataloader.close()
            logger.removeHandler(self._log_handler)
            self._log_handler.close()
