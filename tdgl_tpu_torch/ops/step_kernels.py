"""The fused step kernels: hand-written CUDA on the card, plain PyTorch on
the CPU.

Counterpart of :mod:`tdgl_tpu.ops.pallas_step` (same names, same return
values). Each wrapper routes by the device of the tensors it is given:

* a CPU tensor goes to the plain version — the composition of the ported
  :mod:`tdgl_tpu_torch.models.gtdgl_stencil` functions;
* a CUDA tensor goes to the kernel in ``csrc/`` (built on first use by
  :mod:`tdgl_tpu_torch.ops.kernel_build`), or the wrapper raises. There is
  no fallback from the kernel to the plain version.

Both kernels take the raw link form (:class:`LinkPhases`, reading the
``ur``/``ui`` planes) and the factored form (:class:`FactoredLinkPhases`,
rebuilding the links from row/column vectors). Each wrapper counts its
kernel launches in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models import gtdgl_stencil as gs


def plain_psi_update(gamma, u, sten, U, pr, pi, mu, epsilon, dt):
    res = gs.implicit_euler_psi(sten, U, pr, pi, pr * pr + pi * pi, mu,
                                epsilon, gamma, u, dt)
    return res.psi_r, res.psi_i, res.abs_sq_psi, res.ok


def plain_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term):
    J_s = gs.supercurrent_on_edges(sten, U, pr, pi)
    return gs.poisson_rhs(sten, J_s, dA_dt, neumann_term)


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device} (cpu or cuda)")
    return False


def _check(name: str, t: torch.Tensor, shape, ref: torch.Tensor) -> int:
    """Validate one kernel operand; returns its data pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
    if t.dtype != ref.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {ref.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected"
                         f" {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _link_ptrs(U, ref: torch.Tensor):
    """``(factored, [ur, ui, cf, sf, cg, sg] pointers)`` for the kernels."""
    R, C = ref.shape
    if isinstance(U, gs.FactoredLinkPhases):
        return 1, [None, None,
                   _check("U.cf", U.cf, (3, R), ref),
                   _check("U.sf", U.sf, (3, R), ref),
                   _check("U.cg", U.cg, (3, C), ref),
                   _check("U.sg", U.sg, (3, C), ref)]
    if isinstance(U, gs.LinkPhases):
        return 0, [_check("U.ur", U.ur, (3, R, C), ref),
                   _check("U.ui", U.ui, (3, R, C), ref),
                   None, None, None, None]
    raise TypeError(f"unsupported link phases {type(U).__name__}")


def _dt_tensor(dt, ref: torch.Tensor) -> torch.Tensor:
    if isinstance(dt, torch.Tensor):
        _check("dt", dt.reshape(()), (), ref)
        return dt
    return torch.full((), float(dt), dtype=ref.dtype, device=ref.device)


def _kernel(name: str, dtype: torch.dtype):
    from .kernel_build import load_library

    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"the CUDA kernels take float32 or float64, not"
                        f" {dtype}")
    return getattr(load_library(), f"{name}_{suffix}")


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed"
                           f" (cudaGetLastError() = {rc})")


def fused_psi_update(gamma: float, u: float, sten, U, pr, pi, mu, epsilon,
                     dt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fused covariant Laplacian + implicit-Euler psi update (``old_sq``
    is recomputed from ``pr``/``pi``). Returns ``(new_r, new_i, new_sq,
    ok)``, with ``ok`` a 0-d bool tensor on the tensors' device."""
    if _on_cpu(pr):
        return plain_psi_update(gamma, u, sten, U, pr, pi, mu, epsilon, dt)
    shape = tuple(pr.shape)
    if len(shape) != 2:
        raise ValueError(f"pr must be 2-D, got shape {shape}")
    plane = [_check(n, t, shape, pr) for n, t in (
        ("pr", pr), ("pi", pi), ("mu", mu), ("epsilon", epsilon))]
    w = _check("sten.w", sten.w, (3,) + shape, pr)
    site = [_check(f"sten.{n}", getattr(sten, n), shape, pr) for n in (
        "sym_diag", "inv_area", "fixed_mask", "valid")]
    factored, links = _link_ptrs(U, pr)
    dt_t = _dt_tensor(dt, pr)
    out_r = torch.empty_like(pr)
    out_i = torch.empty_like(pr)
    out_sq = torch.empty_like(pr)
    bad = torch.zeros(1, dtype=torch.int32, device=pr.device)
    fn = _kernel("tdgl_psi_update", pr.dtype)
    rc = fn(*plane, w, *site, *links, factored, dt_t.data_ptr(),
            float(gamma), float(u), out_r.data_ptr(), out_i.data_ptr(),
            out_sq.data_ptr(), bad.data_ptr(), shape[0], shape[1],
            torch.cuda.current_stream(pr.device).cuda_stream)
    _raise_on_error("fused_psi_update", rc)
    fused_psi_update.launches += 1
    return out_r, out_i, out_sq, (bad == 0).reshape(())


def fused_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term) -> torch.Tensor:
    """Fused ``poisson_rhs(sten, supercurrent_on_edges(sten, U, pr, pi),
    dA_dt, neumann_term)``; the edge currents never reach memory."""
    if _on_cpu(pr):
        return plain_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term)
    shape = tuple(pr.shape)
    if len(shape) != 2:
        raise ValueError(f"pr must be 2-D, got shape {shape}")
    psi = [_check("pr", pr, shape, pr), _check("pi", pi, shape, pr)]
    factored, links = _link_ptrs(U, pr)
    edge = [_check(n, t, (3,) + shape, pr) for n, t in (
        ("sten.inv_len", sten.inv_len), ("sten.dual", sten.dual),
        ("dA_dt", dA_dt))]
    site = [_check("sten.inv_area", sten.inv_area, shape, pr),
            _check("neumann_term", neumann_term, shape, pr)]
    rhs = torch.empty_like(pr)
    fn = _kernel("tdgl_poisson_rhs", pr.dtype)
    rc = fn(*psi, *links, factored, *edge, *site, rhs.data_ptr(),
            shape[0], shape[1],
            torch.cuda.current_stream(pr.device).cuda_stream)
    _raise_on_error("fused_poisson_rhs", rc)
    fused_poisson_rhs.launches += 1
    return rhs


fused_psi_update.launches = 0
fused_poisson_rhs.launches = 0
KERNELS = (fused_psi_update, fused_poisson_rhs)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
