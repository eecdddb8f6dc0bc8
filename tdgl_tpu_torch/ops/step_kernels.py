"""The fused step kernels: hand-written CUDA on the card, plain PyTorch on
the CPU.

Counterpart of :mod:`tdgl_tpu.ops.pallas_step` (same names, same return
values). Each call routes by the device of the ``pr`` it is given:

* a CPU tensor goes to the plain version — the composition of the ported
  :mod:`tdgl_tpu_torch.models.gtdgl_stencil` functions;
* a CUDA tensor goes to the kernel in ``csrc/`` (built on first use by
  :mod:`tdgl_tpu_torch.ops.kernel_build`), or the call raises. There is
  no fallback from the kernel to the plain version.

Both kernels take the raw link form (:class:`LinkPhases`, reading the
``ur``/``ui`` planes) and the factored form (:class:`FactoredLinkPhases`,
rebuilding the links from row/column vectors).

The operands that stay fixed over a chunk (stencil planes, link form,
``dA_dt``, the Neumann term) are checked once, by :class:`StepOperands`;
its :meth:`~StepOperands.psi_update` and :meth:`~StepOperands.poisson_rhs`
check only the per-step tensors. :func:`fused_psi_update` and
:func:`fused_poisson_rhs` bind and call in one go. Kernel launches are
counted in ``fused_psi_update.launches`` and ``fused_poisson_rhs.launches``.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def _check(name: str, t, shape, device, dtype) -> int:
    """Validate one kernel operand; returns its data pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected"
                         f" {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _tile() -> Tuple[int, int]:
    """The kernels' (rows, cols) site tile, as the library reports it."""
    from . import kernel_build

    kernel_build.load_library()
    return kernel_build.TILE


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


# The psi kernel's flag word (failing blocks << 16 | blocks counted), one
# per device, zeroed once. The kernel's last block resets it, so launches
# on one stream reuse it.
_FLAG_WORDS: Dict[torch.device, torch.Tensor] = {}


def _flag_word(device: torch.device) -> torch.Tensor:
    word = _FLAG_WORDS.get(device)
    if word is None:
        word = torch.zeros(1, dtype=torch.int32, device=device)
        _FLAG_WORDS[device] = word
    return word


class StepOperands:
    """The chunk-constant operands of both step kernels, checked once.

    ``sten`` is the stencil (its ``valid`` plane sets the device, dtype and
    grid shape), ``U`` the link form; ``dA_dt`` and ``neumann_term`` are
    needed by :meth:`poisson_rhs` only. On the card the constructor checks
    the device, dtype, shape, contiguity and tile multiple of every operand
    and keeps their data pointers (and the tensors, so the pointers stay
    live); on the CPU it only keeps the tensors for the plain versions.
    """

    def __init__(self, sten, U, dA_dt=None, neumann_term=None):
        self.sten, self.U = sten, U
        self.dA_dt, self.neumann_term = dA_dt, neumann_term
        ref = sten.valid
        self.device, self.dtype, self.shape = ref.device, ref.dtype, ref.shape
        if _on_cpu(ref):
            return
        if len(self.shape) != 2:
            raise ValueError(f"sten.valid must be 2-D, got shape"
                             f" {tuple(self.shape)}")
        R, C = self.shape
        tile = _tile()
        if R % tile[0] or C % tile[1]:
            raise ValueError(f"grid {(R, C)} is not a multiple of the"
                             f" kernels' {tile} tile")
        site, edge = self.shape, torch.Size((3, R, C))

        def ptr(name, t, shape):
            return _check(name, t, shape, self.device, self.dtype)

        if isinstance(U, gs.FactoredLinkPhases):
            self.factored = 1
            self.links = (None, None,
                          ptr("U.cf", U.cf, (3, R)), ptr("U.sf", U.sf, (3, R)),
                          ptr("U.cg", U.cg, (3, C)), ptr("U.sg", U.sg, (3, C)))
        elif isinstance(U, gs.LinkPhases):
            self.factored = 0
            self.links = (ptr("U.ur", U.ur, edge), ptr("U.ui", U.ui, edge),
                          None, None, None, None)
        else:
            raise TypeError(f"unsupported link phases {type(U).__name__}")
        self.psi_planes = (
            ptr("sten.w", sten.w, edge),
            *(ptr(f"sten.{n}", getattr(sten, n), site)
              for n in ("sym_diag", "inv_area", "fixed_mask", "valid")))
        self.rhs_planes = None
        if dA_dt is not None or neumann_term is not None:
            self.rhs_planes = (
                ptr("sten.inv_len", sten.inv_len, edge),
                ptr("sten.dual", sten.dual, edge),
                ptr("dA_dt", dA_dt, edge),
                ptr("sten.inv_area", sten.inv_area, site),
                ptr("neumann_term", neumann_term, site))

    def _plane(self, name, t) -> int:
        return _check(name, t, self.shape, self.device, self.dtype)

    def _dt_ptr(self, dt):
        """``(pointer, tensor)`` of the device scalar dt (a float makes a
        one-element tensor, i.e. one fill on the device)."""
        if not isinstance(dt, torch.Tensor):
            dt = torch.full((), float(dt), dtype=self.dtype,
                            device=self.device)
        return _check("dt", dt.reshape(()), (), self.device, self.dtype), dt

    def psi_update(self, gamma: float, u: float, pr, pi, mu, epsilon, dt
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """Fused covariant Laplacian + implicit-Euler psi update (``old_sq``
        is recomputed from ``pr``/``pi``). Returns ``(new_r, new_i,
        new_sq, ok)``, with ``ok`` a 0-d bool tensor on the tensors'
        device. One kernel launch, no other device work."""
        if _on_cpu(pr):
            return plain_psi_update(gamma, u, self.sten, self.U, pr, pi, mu,
                                    epsilon, dt)
        planes = (self._plane("pr", pr), self._plane("pi", pi),
                  self._plane("mu", mu), self._plane("epsilon", epsilon))
        # dt_keep holds a dt made here from a float until the launch.
        dt_ptr, dt_keep = self._dt_ptr(dt)
        out_r = torch.empty_like(pr)
        out_i = torch.empty_like(pr)
        out_sq = torch.empty_like(pr)
        ok = torch.empty((), dtype=torch.bool, device=pr.device)
        rc = _kernel("tdgl_psi_update", self.dtype)(
            *planes, *self.psi_planes, *self.links, self.factored, dt_ptr,
            float(gamma), float(u), out_r.data_ptr(), out_i.data_ptr(),
            out_sq.data_ptr(), _flag_word(pr.device).data_ptr(),
            ok.data_ptr(), self.shape[0], self.shape[1],
            torch.cuda.current_stream(pr.device).cuda_stream)
        _raise_on_error("fused_psi_update", rc)
        fused_psi_update.launches += 1
        return out_r, out_i, out_sq, ok

    def poisson_rhs(self, pr, pi) -> torch.Tensor:
        """Fused ``poisson_rhs(sten, supercurrent_on_edges(sten, U, pr,
        pi), dA_dt, neumann_term)``; the edge currents never reach
        memory."""
        if _on_cpu(pr):
            return plain_poisson_rhs(self.sten, self.U, pr, pi, self.dA_dt,
                                     self.neumann_term)
        psi = (self._plane("pr", pr), self._plane("pi", pi))
        if self.rhs_planes is None:
            raise ValueError("poisson_rhs needs operands bound with dA_dt"
                             " and neumann_term")
        rhs = torch.empty_like(pr)
        rc = _kernel("tdgl_poisson_rhs", self.dtype)(
            *psi, *self.links, self.factored, *self.rhs_planes,
            rhs.data_ptr(), self.shape[0], self.shape[1],
            torch.cuda.current_stream(pr.device).cuda_stream)
        _raise_on_error("fused_poisson_rhs", rc)
        fused_poisson_rhs.launches += 1
        return rhs


def fused_psi_update(gamma: float, u: float, sten, U, pr, pi, mu, epsilon,
                     dt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """:meth:`StepOperands.psi_update` with ``(sten, U)`` bound for this
    call only."""
    return StepOperands(sten, U).psi_update(gamma, u, pr, pi, mu, epsilon,
                                            dt)


def fused_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term) -> torch.Tensor:
    """:meth:`StepOperands.poisson_rhs` with the operands bound for this
    call only."""
    return StepOperands(sten, U, dA_dt, neumann_term).poisson_rhs(pr, pi)


fused_psi_update.launches = 0
fused_poisson_rhs.launches = 0
KERNELS = (fused_psi_update, fused_poisson_rhs)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
