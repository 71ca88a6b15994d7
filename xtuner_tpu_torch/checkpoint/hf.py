"""HuggingFace safetensors import and export (counterpart:
`xtuner_tpu/checkpoint/hf.py`).

The machine with the card has no `safetensors` package, so this module
reads and writes the format itself: an 8-byte little-endian header length,
a JSON header mapping each tensor name to its dtype, shape and
`data_offsets` (begin, end) in the byte buffer that follows, then the raw
bytes, tensor after tensor with no gaps.

- Load (`load_hf_checkpoint`): leaf by leaf through each leaf's `HFKey`
  (`checkpoint/spec.py`): the `linear` transpose of nn.Linear's (out, in),
  layer stacks (`layer_offset` / `layer_stride`), per-expert keys stacked
  on the expert dim, the gate / up halves of a fused (E, H, 2F) expert
  tensor. Each HF tensor is read alone, moved to the requested device and
  copied into its slot of a leaf made there in the requested dtype, so
  the host never holds more than one tensor of the model.
- Save (`save_hf_checkpoint`): layer by layer from the device into shards
  capped at `MAX_SHARD_BYTES`, with JAX's shard names, its
  `model.safetensors.index.json` and its minimal `config.json`
  (`_write_hf_config`); `async_save_hf_checkpoint` snapshots the params to
  the host and writes on one background thread, as JAX's does.

A checkpoint written by either package loads in the other, and the
`safetensors` package reads the port's files. Any model with an
`hf_key_map` loads and saves here, InternVL's compose model included
(`model/compose.py`: its patch embedding is a 2-D "linear" weight); a
Conv3d key (`conv3d:` transforms, Qwen3-VL's patch embedding) raises
([serve-rest]).

LoRA and QLoRA on load: a `<random>` leaf (an adapter the checkpoint
lacks) is drawn by `module/params.py::init_params` from the caller's
seeded generator (not JAX's key stream: tests carry JAX's values across);
an `nf4_pack` / `nf4_scale` leaf reads its HF weight one layer at a time,
moves it to the device, transposes it to (in, out) and quantizes it there
(`module/quant.py::quantize_nf4_device`, JAX's codes bit for bit); the
codes and the scales of one weight come from one quantization. An export
holds no such leaf: a LoRA model is merged first (`merge_lora`) and
written with the plain key map.
"""

from __future__ import annotations

import json
import struct
import threading
from pathlib import Path

import torch

from .. import not_ported
from ..module.params import init_params, tree_paths
from ..module.quant import quantize_nf4_device
from ..utils.logger import get_logger
from .spec import HFKey

logger = get_logger()

MAX_SHARD_BYTES = int(3.6 * 1024**3)

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
          "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: Path) -> tuple[dict, int]:
    """(the JSON header without `__metadata__`, the offset of the byte
    buffer) of one safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class HFCheckpointReader:
    """Reads single tensors of an HF checkpoint directory: one
    `model.safetensors`, or the shards named by
    `model.safetensors.index.json`'s weight map."""

    def __init__(self, hf_path: str | Path):
        self.path = Path(hf_path)
        index_file = self.path / "model.safetensors.index.json"
        if index_file.exists():
            self.weight_map: dict[str, str] = json.loads(index_file.read_text())["weight_map"]
        else:
            single = self.path / "model.safetensors"
            if not single.exists():
                raise FileNotFoundError(f"No safetensors found under {self.path}")
            self.weight_map = {k: single.name for k in read_header(single)[0]}
        self._headers: dict[str, tuple[dict, int]] = {}

    def has(self, key: str) -> bool:
        return key in self.weight_map

    def _meta(self, key: str) -> tuple[Path, dict, int]:
        if key not in self.weight_map:
            raise KeyError(f"HF checkpoint missing key {key!r}")
        name = self.weight_map[key]
        if name not in self._headers:
            self._headers[name] = read_header(self.path / name)
        header, start = self._headers[name]
        return self.path / name, header[key], start

    def get(self, key: str) -> torch.Tensor:
        """The tensor `key` as a new CPU tensor in its stored dtype."""
        path, meta, start = self._meta(key)
        dtype, shape = DTYPES[meta["dtype"]], tuple(meta["shape"])
        b, e = meta["data_offsets"]
        if e == b:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(e - b)
        with open(path, "rb") as f:
            f.seek(start + b)
            if f.readinto(buf) != e - b:
                raise ValueError(f"{path.name}: tensor {key!r} is cut short")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def _is_stacked(key: HFKey) -> bool:
    return "{layer}" in key.template


def _hf_layer(key: HFKey, li: int) -> int:
    return li * key.layer_stride + key.layer_offset


def _check_key(key) -> HFKey:
    if key is None:
        raise ValueError("param has no HF key mapping")
    if key.transform.startswith("conv3d"):
        raise not_ported("the vision tower's Conv3d patch embedding", "serve-rest")
    return key


def _fill(dst: torch.Tensor, reader: HFCheckpointReader, key: HFKey, layer: int) -> None:
    """Copy the HF tensor(s) of one layer slice (or of an unstacked leaf)
    into `dst` (our layout), on dst's device and in its dtype."""
    dev = dst.device

    def get(name: str, shape) -> torch.Tensor:
        t = reader.get(name).to(dev)
        if key.transform in ("linear", "expert_linear"):
            t = t.T
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"HF tensor {name!r}: shape {tuple(t.shape)} (our layout) "
                             f"!= param slice {tuple(shape)}")
        return t

    if key.transform == "expert_linear":
        for ei in range(dst.shape[0]):
            dst[ei].copy_(get(key.template.format(layer=layer, expert=ei), dst.shape[1:]))
    elif key.transform in ("fused3d_half0", "fused3d_half1"):
        f = dst.shape[-1]
        off = f if key.transform == "fused3d_half1" else 0
        name = key.template.format(layer=layer)
        t = reader.get(name).to(dev)
        dst.copy_(t[..., off:off + f])
    else:
        dst.copy_(get(key.template.format(layer=layer), dst.shape))


def _leaf_pairs(specs, key_map) -> list[tuple[tuple, object, HFKey]]:
    """(path, spec, key) of every leaf, in the sorted-key order of
    `jax.tree.flatten`; raises if the key map does not cover the tree."""
    keys = dict(tree_paths(key_map))
    pairs = list(tree_paths(specs))
    missing = [".".join(p) for p, _ in pairs if p not in keys]
    extra = sorted(".".join(p) for p in set(keys) - {p for p, _ in pairs})
    if missing or extra:
        raise ValueError(f"HF key map does not match the param tree: missing {missing}, "
                         f"extra {extra}")
    return [(p, s, keys[p]) for p, s in pairs]


def _set_path(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _nf4_block(specs, path: tuple) -> int:
    """The NF4 block size of the projection at `path` (its `w_q4` and
    `w_absmax` specs: two codes a byte, one scale a block)."""
    proj = specs
    for k in path[:-1]:
        proj = proj[k]
    return 2 * proj["w_q4"].shape[-1] // proj["w_absmax"].shape[-1]


def _fill_nf4(dst: torch.Tensor, reader: HFCheckpointReader, key: HFKey, layer: int,
              block: int, pending: dict) -> None:
    """An NF4 leaf's layer slice: the HF weight on dst's device, transposed
    to (in, out) and quantized there; the codes or the scales go into dst,
    the other half waits in `pending` for its own leaf."""
    name = key.template.format(layer=layer)
    want = 0 if key.transform == "nf4_pack" else 1
    if name not in pending:
        w = reader.get(name).to(dst.device).T
        pending[name] = [*quantize_nf4_device(w, block), 2]
    got = pending[name]
    dst.copy_(got[want])
    got[2] -= 1
    if not got[2]:
        del pending[name]


@torch.no_grad()
def load_hf_checkpoint(hf_path: str | Path, specs, key_map, device, dtype=torch.float32,
                       generator=None):
    """-> a param tree shaped like `specs` (ParamSpec leaves), each leaf
    made on `device` in `dtype` (or in its spec's own dtype: NF4 codes and
    scales) and filled from the HF files; `<random>` leaves are drawn from
    `generator` (a generator on `device`, seed 0 when None)."""
    reader = HFCheckpointReader(hf_path)
    params: dict = {}
    pending: dict = {}  # HF weight -> [codes, scales, leaves still to take one]
    for path, spec, key in _leaf_pairs(specs, key_map):
        key = _check_key(key)
        if key.template == "<random>":
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            _set_path(params, path, init_params(spec, generator, device, dtype))
            continue
        out = torch.empty(spec.shape, dtype=spec.dtype or dtype, device=device)
        stacked = _is_stacked(key)
        for li in range(spec.shape[0] if stacked else 1):
            dst = out[li] if stacked else out
            hf_layer = _hf_layer(key, li) if stacked else 0
            if key.transform.startswith("nf4"):
                _fill_nf4(dst, reader, key, hf_layer, _nf4_block(specs, path), pending)
            else:
                _fill(dst, reader, key, hf_layer)
        _set_path(params, path, out)
    logger.info(f"loaded {len(list(tree_paths(params)))} params from HF checkpoint {hf_path}")
    return params


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------

def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """One safetensors file of CPU tensors, names in sorted order, the
    header padded with spaces to 8 bytes (as the `safetensors` package
    writes it), `{"format": "pt"}` as its metadata."""
    header: dict = {"__metadata__": {"format": "pt"}}
    off = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name]
            if t.numel():
                f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
    tmp.rename(path)


class _ChunkedWriter:
    """Collect tensors and write them in shards capped at MAX_SHARD_BYTES
    (JAX `_ChunkedWriter`: a shard closes once it reaches the cap). Each
    shard goes to disk as it closes, under a temporary name; `finalize`
    gives the shards their final names once their count is known."""

    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.buffer: dict[str, torch.Tensor] = {}
        self.buffer_bytes = 0
        self.parts: list[tuple[Path, list[str], int]] = []

    def add(self, key: str, tensor: torch.Tensor) -> None:
        self.buffer[key] = tensor
        self.buffer_bytes += tensor.numel() * tensor.element_size()
        if self.buffer_bytes >= MAX_SHARD_BYTES:
            self.flush()

    def flush(self) -> None:
        if self.buffer:
            part = self.out_dir / f".part-{len(self.parts):05d}.safetensors"
            write_safetensors(part, self.buffer)
            self.parts.append((part, list(self.buffer), self.buffer_bytes))
            self.buffer, self.buffer_bytes = {}, 0

    def finalize(self) -> None:
        self.flush()
        n = len(self.parts)
        if n == 1:
            self.parts[0][0].rename(self.out_dir / "model.safetensors")
            return
        weight_map = {}
        for i, (part, keys, _) in enumerate(self.parts, start=1):
            name = f"model-{i:05d}-of-{n:05d}.safetensors"
            part.rename(self.out_dir / name)
            weight_map.update({k: name for k in keys})
        total = sum(b for _, _, b in self.parts)
        (self.out_dir / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))


def _to_hf_tensor(t: torch.Tensor, transform: str) -> torch.Tensor:
    """Our layout -> the HF tensor, contiguous on the host."""
    if transform in ("linear", "expert_linear"):
        t = t.T
    return t.detach().contiguous().cpu()


@torch.no_grad()
def save_hf_checkpoint(hf_path: str | Path, params, key_map, model_cfg=None) -> None:
    """params -> HF safetensors under `hf_path`, a layer slice at a time."""
    out_dir = Path(hf_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = _ChunkedWriter(out_dir)
    fused_halves: dict[str, list] = {}  # fused3d gate/up pairs awaiting merge
    for _path, p, key in _leaf_pairs(params, key_map):
        key = _check_key(key)
        if key.template == "<random>" or key.transform.startswith("nf4"):
            raise ValueError(f"{'.'.join(_path)}: LoRA adapters and NF4 bases have no HF "
                             "tensor of their own; merge the adapters first (merge_lora) "
                             "and export with the plain key map")
        stacked = _is_stacked(key)
        if key.transform in ("fused3d_half0", "fused3d_half1"):
            for li in range(p.shape[0] if stacked else 1):
                hf_key = key.template.format(layer=_hf_layer(key, li))
                slot = fused_halves.setdefault(hf_key, [None, None])
                slot[int(key.transform.endswith("1"))] = p[li] if stacked else p
                if slot[0] is not None and slot[1] is not None:
                    writer.add(hf_key, torch.cat(slot, dim=-1).contiguous().cpu())
                    del fused_halves[hf_key]
        elif key.transform == "expert_linear":
            layers = p if p.ndim == 4 else p[None]
            for li, layer in enumerate(layers):
                for ei in range(layer.shape[0]):
                    writer.add(key.template.format(layer=_hf_layer(key, li), expert=ei),
                               _to_hf_tensor(layer[ei], key.transform))
        elif stacked:
            for li in range(p.shape[0]):
                writer.add(key.template.format(layer=_hf_layer(key, li)),
                           _to_hf_tensor(p[li], key.transform))
        else:
            writer.add(key.template, _to_hf_tensor(p, key.transform))
    writer.finalize()
    if model_cfg is not None and getattr(model_cfg, "model_type", None):
        _write_hf_config(out_dir, model_cfg)
    logger.info(f"saved HF checkpoint -> {out_dir}")


class _SaveHandle:
    def __init__(self, thread: threading.Thread):
        self._thread = thread

    def join(self, timeout=None) -> None:
        self._thread.join(timeout)

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()


def async_save_hf_checkpoint(hf_path: str | Path, params, key_map, model_cfg=None):
    """Snapshot the params to the host, then write the safetensors on one
    background thread. Returns a handle with `.join()` and `.done`."""
    host = {}
    for path, p in tree_paths(params):
        _set_path(host, path, p.detach().to("cpu", copy=True))
    thread = threading.Thread(target=save_hf_checkpoint,
                              args=(hf_path, host, key_map, model_cfg), daemon=True)
    thread.start()
    return _SaveHandle(thread)


def _write_hf_config(out_dir: Path, cfg) -> None:
    """JAX's minimal HF config.json, key for key."""
    attn = cfg.attention
    config = {
        "architectures": [],
        "model_type": cfg.model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": attn.num_attention_heads,
        "num_key_value_heads": attn.num_key_value_heads,
        "head_dim": attn.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "hidden_act": cfg.hidden_act,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "eos_token_id": cfg.eos_token_id,
        "torch_dtype": "bfloat16",
    }
    for extra in ("n_routed_experts", "num_experts_per_tok", "moe_intermediate_size"):
        if hasattr(cfg, extra):
            config[{"n_routed_experts": "num_experts"}.get(extra, extra)] = getattr(cfg, extra)
    (out_dir / "config.json").write_text(json.dumps(config, indent=1))

