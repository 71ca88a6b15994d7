"""float64 oracles of the tile-wise fp8 GEMMs, shared by the fp8 test
modules: exact products of the fp8 codes summed one 128-deep scale tile
at a time, each tile scaled as the kernels scale it."""

import numpy as np


def tile_oracle(xq, sx, wq, sw):
    """float64 sum over K tiles of (x_t . w_t) * sx[:, t] * sw[t, n / 128]."""
    xf, wf = xq.float().double().numpy(), wq.float().double().numpy()
    sxf, swf = sx.double().numpy(), np.repeat(sw.double().numpy(), 128, axis=1)
    y = np.zeros((xf.shape[0], wf.shape[1]))
    for t in range(xf.shape[1] // 128):
        ks = slice(128 * t, 128 * (t + 1))
        y += (xf[:, ks] @ wf[ks]) * sxf[:, t:t + 1] * swf[t][None, :]
    return y


def grouped_oracle(xq, sx, wq, sw, sizes):
    out = np.zeros((xq.shape[0], wq.shape[2]))
    start = 0
    for e, g in enumerate(sizes):
        if g:
            out[start:start + g] = tile_oracle(xq[start:start + g], sx[start:start + g],
                                               wq[e], sw[e])
        start += g
    return out


def rowtile_oracle(xq, sx, yq, sy, sizes, num_experts):
    """float64 sum over 128-row tiles r of (x_r^T y_r) sx[r] sy[r], each
    expert's rows only."""
    xf, yf = xq.float().double().numpy(), yq.float().double().numpy()
    sxf, syf = sx.double().numpy()[:, 0], sy.double().numpy()[:, 0]
    dw = np.zeros((num_experts, xf.shape[1], yf.shape[1]))
    start = 0
    for e, g in enumerate(sizes):
        for r in range(start // 128, (start + g + 127) // 128 if g else start // 128):
            lo, hi = max(start, 128 * r), min(start + g, 128 * (r + 1))
            dw[e] += (xf[lo:hi].T @ yf[lo:hi]) * sxf[r] * syf[r]
        start += g
    return dw
