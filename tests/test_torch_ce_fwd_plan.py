"""The fused-CE forward's work decomposition (`ops/fused_ce.py`:
`ce_fwd_partials_plain`, `ce_lse_combine_plain`, `ce_fwd_scratch_bytes`)
against the JAX package.

On a card the forward (TPU kernel #8) sweeps (256-column vocab tile,
128-row tile) items: each writes per row the tile's max logit (times
log2 e) and the sum of exp2 of its columns < V, and a second kernel folds
each row's pairs in vocab-tile order into lse; the label logit comes from
the tile that holds it. Here that decomposition in plain torch is held
against JAX's `ce_lse_and_label_vh`, whose Pallas kernel runs in interpret
mode on the CPU (as `tests/ops/test_fused_ce.py` runs it), at vocabularies
that are not a multiple of 256, labels in the tail tile and N not a
multiple of 128. Inputs are numpy arrays from a seed. Tolerance: 2e-5 of
the largest entry (`tests/test_torch_fused_ce.py`'s f32 bound: the same
f32 products summed in another order; bf16 operands multiply exactly in
f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.fused_ce import ce_lse_and_label_vh as j_ce_lse_and_label_vh
from xtuner_tpu_torch.ops import fused_ce as fc

F32_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, v, hd, seed):
    """h, w as numpy f32; labels with every tenth row in the vocab's last
    256-column tile (the ragged one) and the last row at V - 1."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, hd), dtype=np.float32)
    w = (rng.standard_normal((v, hd)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    tail0 = (v - 1) // fc.VOCAB_TILE * fc.VOCAB_TILE
    labels[::10] = rng.integers(tail0, v, len(labels[::10]))
    labels[-1] = v - 1
    return h, w, labels


def _close(got, want, rtol, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


@pytest.mark.parametrize("n,v,hd,dtype", [
    (328, 1000, 128, "float32"),    # 4 vocab tiles, the last of 232 columns; 2 x 128 + 72 rows
    (200, 5000, 128, "float32"),    # 20 tiles, the last of 136 columns
    (200, 5000, 256, "bfloat16"),   # the working dtype
    (72, 100, 128, "float32"),      # one vocab tile, less than one row tile
])
def test_partials_and_combine_match_jax(n, v, hd, dtype):
    h, w, labels = _inputs(n, v, hd, seed=n + v + hd)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jlse, jlab = j_ce_lse_and_label_vh(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                                       jnp.asarray(labels), interpret=True)
    th, tw = torch.tensor(h).to(tdt), torch.tensor(w).to(tdt)
    part, lab = fc.ce_fwd_partials_plain(th, tw, torch.tensor(labels))
    assert part.shape == (-(-v // fc.VOCAB_TILE), n, 2) and part.dtype == torch.float32
    lse = fc.ce_lse_combine_plain(part)
    assert lse.dtype == lab.dtype == torch.float32
    _close(lse.numpy(), jlse, F32_TOL, "lse")
    _close(lab.numpy(), jlab, F32_TOL, "label logit")


def test_partials_per_tile():
    """Each vocab tile's pair: its max logit times log2 e, and the sum of
    exp2 of its columns' logits less that max (at least 1: the max's own
    term); the last tile holds only the columns < V."""
    h, w, labels = _inputs(130, 600, 128, seed=1)
    th, tw, tl = torch.tensor(h), torch.tensor(w), torch.tensor(labels)
    part, lab = fc.ce_fwd_partials_plain(th, tw, tl)
    logits = (th.double() @ tw.double().T)
    log2e = 1 / np.log(2.0)
    for t, (v0, v1) in enumerate(((0, 256), (256, 512), (512, 600))):
        tile = logits[:, v0:v1]
        m2 = tile.max(dim=1).values * log2e
        _close(part[t, :, 0].numpy(), m2.numpy(), F32_TOL, f"tile {t} max")
        _close(part[t, :, 1].numpy(), torch.exp2(tile * log2e - m2[:, None]).sum(1).numpy(),
               F32_TOL, f"tile {t} sum")
        assert (part[t, :, 1] >= 1 - 1e-6).all()
    _close(lab.numpy(), logits.gather(1, tl[:, None].long())[:, 0].numpy(), F32_TOL, "label")


def test_combine_folds_in_tile_order():
    """The fold equals logsumexp over all the tiles' columns, also where a
    tile's max lies far below another's (its sum underflows to nothing)."""
    part = torch.tensor([[[1.0, 2.0]], [[-200.0, 5.0]], [[3.5, 1.25]]])
    want = np.log(2 * 2.0 ** 1 + 5 * 2.0 ** -200 + 1.25 * 2.0 ** 3.5)
    _close(fc.ce_lse_combine_plain(part).numpy(), [want], 1e-6)


@pytest.mark.parametrize("n,want", [(16384, 77_856_768), (65536, 311_427_072)])
def test_scratch_bound_at_qwen_vocab(n, want):
    """The per-tile pairs at V151936 (594 tiles): 78 MB for the sft paths'
    N16384, 311 MB for the longctx row's N65536."""
    assert fc.ce_fwd_scratch_bytes(n, 151936) == want == 8 * n * 594


def test_cpu_forward_wrapper_runs_the_plain_version():
    h, w, labels = _inputs(100, 300, 128, seed=3)
    th, tw, tl = torch.tensor(h), torch.tensor(w), torch.tensor(labels)
    fc.reset_launches()
    lse, lab = fc.ce_fwd(th, tw, tl)
    want_lse, want_lab = fc.ce_fwd_plain(th, tw, tl)
    assert torch.equal(lse, want_lse) and torch.equal(lab, want_lab)
    assert fc.ce_fwd.launches == 0
    _close(fc.ce_lse_combine_plain(fc.ce_fwd_partials_plain(th, tw, tl)[0]).numpy(),
           want_lse.numpy(), F32_TOL, "the tiled fold against the plain version")
