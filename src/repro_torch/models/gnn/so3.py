"""SO(3) substrate for the equivariant GNNs (MACE, EquiformerV2/eSCN), the
JAX package's ``repro.models.gnn.so3``.

Everything heavy is precomputed on the host in numpy (exact factorial
arithmetic; the float64 tables equal the reference's exactly) and cached
as constant tensors per (device, dtype); the per-edge device work is
dense algebra:

  * real spherical harmonics Y_lm (associated-Legendre recursion, generic l);
  * Clebsch-Gordan coefficients in the REAL basis (Racah formula + complex→
    real change of basis) for MACE's tensor-product contractions;
  * exact real-basis Wigner rotations as POLYNOMIAL COEFFICIENT tensors:
    d^l(β) entries are polynomials in cos(β/2), sin(β/2) (Wigner's formula),
    so "align edge to ẑ" evaluates per edge as a closed-form Rz mix and one
    product of the monomials c^i s^j with the coefficient table.

Irrep layout convention: channels-last flat vector over (l, m): index
``l² + (m + l)`` — size (L+1)² for l = 0..L.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch

from repro_torch.models.gnn.common import ipow


def irrep_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def irrep_slices(l_max: int) -> list[slice]:
    return [slice(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]


# ---------------------------------------------------------------------------
# real spherical harmonics (device, generic l, Condon-Shortley-free real form)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _sh_norms(l_max: int) -> np.ndarray:
    """N_lm = sqrt((2l+1)/(4π) · (l-m)!/(l+m)!) for m ≥ 0, flattened."""
    out = np.zeros(irrep_dim(l_max))
    for l in range(l_max + 1):
        for m in range(0, l + 1):
            n = sqrt((2 * l + 1) / (4 * np.pi) * factorial(l - m) / factorial(l + m))
            out[l * l + l + m] = n
            out[l * l + l - m] = n
    return out


def real_sph_harm(vec: torch.Tensor, l_max: int, eps: float = 1e-9) -> torch.Tensor:
    """Y_lm(v̂) for unit(ish) vectors.  vec: [..., 3] -> [..., (L+1)²].

    Associated Legendre by stable recursion; azimuth via cos/sin(mφ)
    recurrences; no trig of arccos.
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    ct = z / r  # cosθ
    rxy = torch.sqrt(x * x + y * y + eps)
    st = rxy / r  # sinθ
    cphi = x / rxy
    sphi = y / rxy

    # P_l^m(ct) for 0 ≤ m ≤ l
    P: dict[tuple[int, int], torch.Tensor] = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (
                (2 * l - 1) * ct * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]
            ) / (l - m)

    # cos(mφ), sin(mφ) recurrences
    cm = [torch.ones_like(cphi), cphi]
    sm = [torch.zeros_like(sphi), sphi]
    for m in range(2, l_max + 1):
        cm.append(2 * cphi * cm[-1] - cm[-2])
        sm.append(2 * cphi * sm[-1] - sm[-2])

    norms = _sh_norms(l_max)
    comps = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            n = float(norms[l * l + l + m])
            if m == 0:
                comps.append(n * P[(l, 0)])
            elif m > 0:
                comps.append(sqrt(2.0) * n * P[(l, m)] * cm[m])
            else:
                comps.append(sqrt(2.0) * n * P[(l, am)] * sm[am])
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# Clebsch-Gordan (host, exact) — complex CG via Racah, then real basis
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """⟨l1 m1 l2 m2 | l3 m3⟩ -> [2l1+1, 2l2+1, 2l3+1] (Racah's formula)."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return out
    f = factorial
    pref_l = sqrt(
        (2 * l3 + 1)
        * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1)
    )
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = sqrt(
                f(l3 + m3) * f(l3 - m3) * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2)
            )
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                denoms = [
                    k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                    l3 - l2 + m1 + k, l3 - l1 - m2 + k,
                ]
                if any(d < 0 for d in denoms):
                    continue
                s += (-1) ** k / np.prod([float(f(d)) for d in denoms])
            out[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return out


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """U with Y^C_{lm} = Σ_m' U[m, m'] Y^R_{lm'} (rows complex m, cols real)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for m in range(-l, l + 1):
        if m == 0:
            U[l, l] = 1.0
        elif m > 0:
            # convention matching ``real_sph_harm`` (CS phase inside P_l^m):
            #   Y^C_m = (Y^R_m + i·Y^R_{-m})/√2,  Y^C_{-m} = (-1)^m (Y^R_m - i·Y^R_{-m})/√2
            U[m + l, m + l] = 1 / sqrt(2)  # cos part
            U[m + l, -m + l] = 1j / sqrt(2)  # sin part
            U[-m + l, m + l] = (-1) ** m / sqrt(2)
            U[-m + l, -m + l] = -1j * (-1) ** m / sqrt(2)
    return U


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG: C[m1, m2, m3] with real Y.  Guaranteed real (up to fp)."""
    C = _cg_complex(l1, l2, l3).astype(np.complex128)
    U1, U2, U3 = _real_to_complex(l1), _real_to_complex(l2), _real_to_complex(l3)
    # C_real = U1† U2† C U3 (contract complex indices onto real ones)
    out = np.einsum("abc,ax,by,cz->xyz", C, U1.conj(), U2.conj(), U3)
    if not (np.abs(out.imag).max() < 1e-10 or np.abs(out.real).max() < 1e-12):
        raise ArithmeticError(f"cg_real{(l1, l2, l3)}: neither real nor imaginary "
                              f"({np.abs(out.imag).max()})")
    # real CG can land purely imaginary for some parities; fold the phase in
    if np.abs(out.imag).max() > np.abs(out.real).max():
        out = out.imag
    else:
        out = out.real
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# Wigner rotations in the real basis, as polynomial coefficient tensors
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _wigner_d_poly(l: int) -> np.ndarray:
    """Coefficients W[m', m, i, j]: d^l_{m'm}(β) = Σ_ij W c^i s^j with
    c = cos(β/2), s = sin(β/2).  Exact from Wigner's formula."""
    dim = 2 * l + 1
    deg = 2 * l + 1
    W = np.zeros((dim, dim, deg, deg))
    f = factorial
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            for k in range(0, 2 * l + 1):
                denoms = [l + m - k, k, mp - m + k, l - mp - k]
                if any(d < 0 for d in denoms):
                    continue
                coef = (-1) ** (mp - m + k) * pref / np.prod(
                    [float(f(d)) for d in denoms]
                )
                ci = 2 * l + m - mp - 2 * k  # power of cos(β/2)
                si = mp - m + 2 * k  # power of sin(β/2)
                W[mp + l, m + l, ci, si] += coef
    return W


@lru_cache(maxsize=None)
def wigner_dy_real_poly(l: int) -> np.ndarray:
    """Real-basis Ry(β) rotation as polynomial tensor P[a, b, i, j]:
    D^l_real(β)_{ab} = Σ_ij P c^i s^j.  (U† d U, U the real↔complex map.)"""
    U = _real_to_complex(l)
    W = _wigner_d_poly(l).astype(np.complex128)
    # D^R = U† d U  (U maps real -> complex coefficients)
    P = np.einsum("xa,abij,by->xyij", U.conj().T, W, U)
    if not np.abs(P.imag).max() < 1e-9:
        raise ArithmeticError(f"wigner_dy_real_poly({l}): imaginary part "
                              f"{np.abs(P.imag).max()}")
    return np.ascontiguousarray(P.real)


@lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`cg_real` as a constant tensor on ``device`` (cached)."""
    return torch.as_tensor(cg_real(l1, l2, l3), dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _poly_matrix(l: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`wigner_dy_real_poly` as [(2l+1)², (2l+1)²] (rows (a, b),
    columns (i, j)) on ``device`` (cached)."""
    d = 2 * l + 1
    return torch.as_tensor(wigner_dy_real_poly(l).reshape(d * d, d * d), dtype=dtype,
                           device=device)


def _rz_into(out: torch.Tensor, base: int, l: int, phi: torch.Tensor) -> None:
    """Write the real-basis Rz(φ) block of degree ``l`` into ``out`` at
    rows and columns ``base - l .. base + l``."""
    out[..., base, base] = 1.0
    for m in range(1, l + 1):
        c, s = torch.cos(m * phi), torch.sin(m * phi)
        ip, im = base + m, base - m
        out[..., ip, ip] = c
        out[..., im, im] = c
        out[..., ip, im] = -s
        out[..., im, ip] = s


def rz_real(l_max: int, phi: torch.Tensor) -> torch.Tensor:
    """Block-diagonal real-basis Rz(φ): closed-form cos/sin(mφ) mixing.

    Returns [..., dim, dim] with dim = (l_max+1)².  Cheap: O(L²) nonzeros.
    """
    dim = irrep_dim(l_max)
    out = phi.new_zeros((*phi.shape, dim, dim))
    for l in range(l_max + 1):
        _rz_into(out, l * l + l, l, phi)
    return out


def _rz_block(l: int, phi: torch.Tensor) -> torch.Tensor:
    """One l-block of the real-basis Rz(φ): [..., 2l+1, 2l+1]."""
    d = 2 * l + 1
    out = phi.new_zeros((*phi.shape, d, d))
    _rz_into(out, l, l, phi)
    return out


def _ry_block(l: int, beta: torch.Tensor) -> torch.Tensor:
    """One l-block of the real-basis Ry(β) via the polynomial tensor: the
    monomials c^i s^j [..., deg²] times the coefficient table (one
    product; powers as ``lax.integer_pow`` rounds them)."""
    deg = 2 * l + 1
    c = torch.cos(beta / 2)
    s = torch.sin(beta / 2)
    cp = torch.stack([ipow(c, i) for i in range(deg)], dim=-1)
    sp = torch.stack([ipow(s, j) for j in range(deg)], dim=-1)
    mono = (cp[..., :, None] * sp[..., None, :]).reshape(*beta.shape, deg * deg)
    return (mono @ _poly_matrix(l, beta.device, beta.dtype).T).reshape(*beta.shape, deg, deg)


def ry_real(l_max: int, beta: torch.Tensor) -> torch.Tensor:
    """Real-basis Ry(β) via the precomputed polynomial tensors."""
    dim = irrep_dim(l_max)
    out = beta.new_zeros((*beta.shape, dim, dim))
    for l in range(l_max + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        out[..., sl, sl] = _ry_block(l, beta)
    return out


def _angles(vec: torch.Tensor, eps: float):
    """(β, φ) of ``vec``: polar angle (clipped off the poles) and azimuth.
    A zero vector (a padding edge) gives β = π/2, φ = atan2(0, 0) = 0."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    beta = torch.arccos(torch.clamp(z / r, -1 + 1e-7, 1 - 1e-7))
    return beta, torch.atan2(y, x)


def align_blocks(vec: torch.Tensor, l_max: int, eps: float = 1e-9) -> list[torch.Tensor]:
    """Per-l rotation blocks aligning ``vec`` to +z (memory-lean form).

    Returns list of [..., 2l+1, 2l+1] for l = 0..l_max.  Storage Σ(2l+1)²
    per element instead of the full (L+1)⁴ dense matrix.
    """
    beta, phi = _angles(vec, eps)
    return [_ry_block(l, -beta) @ _rz_block(l, -phi) for l in range(l_max + 1)]


def align_to_z(vec: torch.Tensor, l_max: int, eps: float = 1e-9):
    """Rotation R (real irrep basis) with R·irreps expressed in the frame
    where ``vec`` points along +z.  Returns (R, R_inv) of shape
    [..., dim, dim].  R = Ry(-β)·Rz(-φ);   R_inv = Rᵀ (orthogonal)."""
    beta, phi = _angles(vec, eps)
    R = ry_real(l_max, -beta) @ rz_real(l_max, -phi)
    return R, R.transpose(-1, -2)
