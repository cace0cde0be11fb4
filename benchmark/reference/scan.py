"""The association score of voichek/kmersGWAS, in float64, and a running
per-column top-k for the control.

For phenotype column y over the N used samples and a k-mer's presence bits
g with N1 present (src/kmers_multiple_databases.cpp:327-363):

    r     = N * sum_i y_i g_i - N1 * sum_i y_i
    score = r^2 / (N N1 - N1^2)          (0 where N N1 - N1^2 <= 0)

and 0 where the MAC test fails (N1 < min_count or N - N1 < min_count;
min_count = max(mac, ceil(maf N)), associate_kmers.cpp:98-102).

Presence rows arrive as (R, W32) int32 words, 32 lanes a word, LSB-first.
y is given over all lanes, zero past the N used samples, so padding lanes
add nothing to the sums; N1 is handed in, as the generated traffic counts it
over all lanes (`n1_of` counts the used lanes of a table's rows).
"""
from __future__ import annotations

import math

import torch


def min_count(n_used: int, maf: float, mac: int) -> int:
    return max(int(mac), math.ceil(n_used * maf))


def unpack(planes: torch.Tensor, dtype) -> torch.Tensor:
    """(R, W32) int32 words -> (R, 32 W32) 0/1 in `dtype`, LSB-first."""
    sh = torch.arange(32, dtype=torch.int32, device=planes.device)
    return ((planes[:, :, None] >> sh) & 1).to(dtype).reshape(
        planes.shape[0], -1)


def n1_of(planes: torch.Tensor, n_used: int) -> torch.Tensor:
    """Present samples among the first n_used lanes of each row, f64."""
    return unpack(planes, torch.uint8)[:, :n_used].sum(
        dim=1, dtype=torch.float64)


def epilogue(yigi, n1, ysum, n_used: int, mc: int):
    """(R, P) sums -> (R, P) scores, in the dtype of yigi."""
    n = float(n_used)
    n1 = n1.to(yigi.dtype)[:, None]
    r = n * yigi - n1 * ysum.to(yigi.dtype)[None, :]
    denom = n * n1 - n1 * n1
    s = torch.where(denom > 0, r * r / denom, torch.zeros_like(r))
    ok = (n1 >= mc) & ((n - n1) >= mc)
    return torch.where(ok, s, torch.zeros_like(s))


def scores64(planes, n1, y64, n_used: int, mc: int, block: int = 1 << 17):
    """(R, P) float64 scores of (R, W32) rows given N1 and the (32 W32, P)
    float64 phenotypes, in blocks of `block` rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ysum = y64.sum(dim=0)
    out = []
    for s in range(0, planes.shape[0], block):
        g = unpack(planes[s:s + block], torch.float64)
        out.append(epilogue(g @ y64, n1[s:s + block], ysum, n_used, mc))
    return torch.cat(out) if out else torch.empty(
        (0, y64.shape[1]), dtype=torch.float64, device=planes.device)


def to_fp8_values(y: torch.Tensor) -> torch.Tensor:
    """y rounded to float8 e4m3 (the control's precision: the one below
    bfloat16), held in float32."""
    return y.to(torch.float8_e4m3fn).to(torch.float32)


def scores_lowp(planes, n1, y32, n_used: int, mc: int,
                block: int = 1 << 18):
    """The control's scores: y in float8 e4m3, the 0/1 bits exact, float32
    sums and epilogue (TF32 products are exact on these operands)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yq = to_fp8_values(y32)
        ysum = y32.to(torch.float64).sum(dim=0).to(torch.float32)
        out = []
        for s in range(0, planes.shape[0], block):
            g = unpack(planes[s:s + block], torch.float32)
            out.append(epilogue(g @ yq, n1[s:s + block], ysum, n_used, mc))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


class RunningTopK:
    """Each column's k highest scores seen so far and their row ids (the
    control's selection; ties keep the row seen first)."""

    def __init__(self, p: int, k: int, device):
        self.v = torch.full((p, k), float("-inf"), device=device)
        self.ids = torch.zeros((p, k), dtype=torch.int64, device=device)
        self.k = k

    def add(self, scores: torch.Tensor, ids: torch.Tensor) -> None:
        """scores (R, P), ids (R,) int64."""
        st = scores.T
        hot = int((st > self.v[:, -1:]).sum(dim=1).max())
        if hot == 0:
            return
        tv, ti = torch.topk(st, min(hot, st.shape[1]), dim=1)
        v = torch.cat([self.v, tv], dim=1)
        i = torch.cat([self.ids, ids[ti]], dim=1)
        v, j = torch.sort(v, dim=1, descending=True, stable=True)
        self.v, self.ids = v[:, :self.k], i.gather(1, j[:, :self.k])
