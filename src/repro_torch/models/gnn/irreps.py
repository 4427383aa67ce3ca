"""Real spherical-harmonic irreps machinery (port of
``repro.models.gnn.irreps``).

Provides, for l <= LMAX:
- ``sph_harm_real``: real SH values Y_lm(n), flat (l, m) layout [.., (L+1)^2];
- ``gaunt_tensor``: real Gaunt coefficients, the integral of Y_a Y_b Y_c
  over the sphere by Gauss-Legendre x uniform-phi quadrature (exact for
  band-limited integrands): MACE's tensor-product coefficients;
- ``align_matrices``: per-edge block-diagonal Wigner rotations W(n) with
  W(n) @ sh(n) = sh(z), the eSCN trick of EquiformerV2.

Wigner small-d matrices come from the eigendecomposition of J_y per l
(numpy); the real basis is the standard complex-to-real SH unitary.

The host tables (``_factorial_ratio``, ``_jy_eig``, ``_complex_to_real``,
``_dy_real_parts``) are JAX's numpy code, bitwise. ``gaunt_tensor``
integrates SH values that JAX evaluates through XLA in float32
(``irreps.py:117-118``); the port evaluates them with its own
``sph_harm_real`` in float32 on the CPU, so its table is JAX's to float32
rounding of the SH values, and the same on every device. The torch
functions compute JAX's formulas; their float32 ``sin``/``cos``/
``atan2``/``exp`` are PyTorch's, not XLA's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

LMAX = 6


def n_lm(l_max: int) -> int:
    return (l_max + 1) ** 2


def lm_index(l: int, m: int) -> int:
    return l * l + l + m


def l_of_lm(l_max: int, first: int = 0) -> torch.Tensor:
    """The l of each flat (l, m) index from ``l = first`` on, counted from
    ``first``: JAX's ``jnp.repeat(x, [2l+1 ...], axis=1)`` of a per-l
    tensor, as a gather."""
    return torch.from_numpy(np.repeat(
        np.arange(l_max + 1 - first),
        [2 * l + 1 for l in range(first, l_max + 1)]))


# ---------------------------------------------------------------------------
# Associated Legendre + real SH (static unroll over (l, m)).
# ---------------------------------------------------------------------------

def _legendre_all(l_max: int, x):
    """P_l^m(x) for 0<=m<=l<=l_max, dict[(l,m)] -> tensor like x."""
    P = {(0, 0): torch.ones_like(x)}
    somx2 = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * somx2 * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * x * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (
                (2 * l - 1) * x * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]
            ) / (l - m)
    return P


def _factorial_ratio(a: int, b: int) -> float:
    """a! / b! for small ints."""
    out = 1.0
    if a >= b:
        for k in range(b + 1, a + 1):
            out *= k
        return out
    for k in range(a + 1, b + 1):
        out /= k
    return out


def sph_harm_real(l_max: int, vecs):
    """Real orthonormal SH evaluated at unit vectors [..., 3] ->
    [..., (l_max+1)^2] in flat (l, m=-l..l) order."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    phi = torch.atan2(y, x)
    ct = torch.clamp(z, -1.0, 1.0)
    P = _legendre_all(l_max, ct)
    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            # orthonormal normalization
            norm = float(np.sqrt(
                (2 * l + 1) / (4 * np.pi) * _factorial_ratio(l - m, l + m)))
            if m == 0:
                row[l] = norm * P[(l, 0)]
            else:
                base = float(np.sqrt(2.0) * norm) * P[(l, m)]
                row[l + m] = base * torch.cos(m * phi)
                row[l - m] = base * torch.sin(m * phi)
        out.extend(row)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Gaunt tensor via quadrature (host, numpy).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """G[a, b, c] = integral of Y_{l1,a} Y_{l2,b} Y_{l3,c} (real SH)."""
    n_theta = 2 * (l1 + l2 + l3) + 8
    n_phi = 2 * (l1 + l2 + l3) + 9
    xs, wts = np.polynomial.legendre.leggauss(n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    wphi = 2 * np.pi / n_phi
    ct, ph = np.meshgrid(xs, phis, indexing="ij")
    st = np.sqrt(1 - ct**2)
    pts = np.stack(
        [st * np.cos(ph), st * np.sin(ph), ct], axis=-1
    ).reshape(-1, 3)
    w = (wts[:, None] * np.ones_like(ph) * wphi).reshape(-1)
    lmax = max(l1, l2, l3)
    # float32 SH values on the CPU, as JAX evaluates them (in float32)
    with torch.no_grad():
        Y = sph_harm_real(lmax, torch.from_numpy(
            pts.astype(np.float32))).numpy()  # [P, (L+1)^2]

    def block(l):
        return Y[:, l * l : (l + 1) * (l + 1)]

    Y1, Y2, Y3 = block(l1), block(l2), block(l3)
    return np.einsum("pa,pb,pc,p->abc", Y1, Y2, Y3, w)


@functools.lru_cache(maxsize=None)
def gaunt_full(l_max: int) -> np.ndarray:
    """Dense [(L+1)^2, (L+1)^2, (L+1)^2] Gaunt tensor (small for l_max<=3)."""
    n = n_lm(l_max)
    G = np.zeros((n, n, n))
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if (l1 + l2 + l3) % 2 or l3 < abs(l1 - l2) or l3 > l1 + l2:
                    continue
                g = gaunt_tensor(l1, l2, l3)
                G[
                    l1 * l1 : (l1 + 1) ** 2,
                    l2 * l2 : (l2 + 1) ** 2,
                    l3 * l3 : (l3 + 1) ** 2,
                ] = g
    return G


# ---------------------------------------------------------------------------
# Wigner rotations (real basis) for edge-frame alignment (eSCN).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jy_eig(l: int):
    """Eigendecomposition of J_y in the complex |l,m> basis."""
    m = np.arange(-l, l + 1)
    dim = 2 * l + 1
    jp = np.zeros((dim, dim), complex)  # J+
    for i in range(dim - 1):
        mm = m[i]
        jp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    jm = jp.conj().T
    jy = (jp - jm) / 2j
    w, V = np.linalg.eigh(jy)
    return w, V


@functools.lru_cache(maxsize=None)
def _complex_to_real(l: int) -> np.ndarray:
    """Unitary T with Y_real = T @ Y_complex (rows: m=-l..l real;
    cols: m=-l..l complex), Condon-Shortley convention."""
    dim = 2 * l + 1
    T = np.zeros((dim, dim), complex)
    for m in range(1, l + 1):
        i_pos, i_neg = l + m, l - m
        T[i_neg, l - m] = 1j / np.sqrt(2)
        T[i_neg, l + m] = -1j * (-1) ** m / np.sqrt(2)
        T[i_pos, l - m] = 1 / np.sqrt(2)
        T[i_pos, l + m] = (-1) ** m / np.sqrt(2)
    T[l, l] = 1.0
    return T


def _dy_real_parts(l: int):
    """Returns (A, w, B) with
    d_real(beta) = Re( A @ diag(e^{-i beta w}) @ B )."""
    w, V = _jy_eig(l)
    T = _complex_to_real(l)
    A = T @ V
    B = V.conj().T @ T.conj().T
    return A, w, B


def _dz_real(l: int, alpha):
    """Rotation about z by alpha in the real SH basis: 2x2 blocks mixing
    (m, -m), [..., dim, dim]: cos(|m| alpha) on the diagonal, and on the
    antidiagonal sin(m alpha) in row l + m, -sin in row l - m."""
    m = torch.arange(-l, l + 1, device=alpha.device)
    am = (m.abs().to(torch.float32) * alpha[..., None])  # [..., dim]
    diag = torch.diag_embed(torch.cos(am))
    anti = torch.diag_embed(torch.sign(m).to(torch.float32) * torch.sin(am))
    return diag + torch.flip(anti, dims=[-1])


def _dy_real(l: int, beta):
    A, w, B = _dy_real_parts(l)
    dev = beta.device
    Aj = torch.from_numpy(A.astype(np.complex64)).to(dev)
    Bj = torch.from_numpy(B.astype(np.complex64)).to(dev)
    wj = torch.from_numpy(w.astype(np.float32)).to(dev)
    phases = torch.exp(-1j * beta[..., None] * wj)  # [..., dim] complex64
    M = (Aj * phases[..., None, :]) @ Bj
    return M.real.to(torch.float32)


def align_matrices(l_max: int, unit_vecs):
    """Per-l Wigner rotations W_l(n) [..., 2l+1, 2l+1] (real basis) with

        blockdiag(W) @ sph_harm_real(n) == sph_harm_real(z)

    i.e. rotation into the edge-aligned frame (eSCN). Returns a list per
    l. The inverse transform is the transpose (orthogonal).
    """
    x, y, z = unit_vecs[..., 0], unit_vecs[..., 1], unit_vecs[..., 2]
    alpha = torch.atan2(y, x)
    # arctan2 form: stable where arccos'(z) blows up near the poles (f32)
    beta = torch.atan2(torch.sqrt(torch.clamp_min(x * x + y * y, 0.0)), z)
    # convention: _d*_real(l, g) is the matrix of the argument rotation by
    # R(-g), so W = dy(+beta) dz(+alpha) takes n -> Rz(-alpha) -> xz-plane
    # -> Ry(-beta) -> z
    return [_dy_real(l, beta) @ _dz_real(l, alpha) for l in range(l_max + 1)]


def rotate_irreps(mats, feats, l_max: int, inverse: bool = False):
    """Apply per-l rotation blocks to flat irreps [..., (L+1)^2, C]."""
    out = []
    for l in range(l_max + 1):
        blk = feats[..., l * l : (l + 1) ** 2, :]
        M = mats[l].transpose(-1, -2) if inverse else mats[l]
        out.append(M @ blk)
    return torch.cat(out, dim=-2)
