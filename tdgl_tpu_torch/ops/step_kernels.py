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

The stencil planes, fixed for a solve, are checked once, by
:class:`StencilOperands`; the operands that may change from call to call
(the link form, ``dA_dt``, the Neumann term) are bound to them in a
:class:`StepOperands` and checked when bound (:meth:`StepOperands.rebind`
checks only what it replaces). Its :meth:`~StepOperands.psi_update` and
:meth:`~StepOperands.poisson_rhs` check only the per-call tensors.
:func:`fused_psi_update` and :func:`fused_poisson_rhs` bind and call in
one go. The RHS kernel has a second form that also writes the edge
supercurrent ``J_s`` (``with_supercurrent``), which the screened step
needs. Kernel launches are counted in ``fused_psi_update.launches`` and
``fused_poisson_rhs.launches`` (both RHS forms).
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch

from ..models import gtdgl_stencil as gs


def plain_psi_update(gamma, u, sten, U, pr, pi, mu, epsilon, dt,
                     abs_sq=None):
    old_sq = pr * pr + pi * pi if abs_sq is None else abs_sq
    res = gs.implicit_euler_psi(sten, U, pr, pi, old_sq, mu, epsilon, gamma,
                                u, dt)
    return res.psi_r, res.psi_i, res.abs_sq_psi, res.ok


def plain_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term,
                      with_supercurrent: bool = False):
    J_s = gs.supercurrent_on_edges(sten, U, pr, pi)
    rhs = gs.poisson_rhs(sten, J_s, dA_dt, neumann_term)
    return (rhs, J_s) if with_supercurrent else rhs


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


class StencilOperands:
    """The stencil planes of both step kernels, checked once.

    What stays fixed for a solve: ``sten.valid`` sets the device, dtype
    and grid shape; on the card the constructor checks the grid against
    the kernels' tile and the device, dtype, shape and contiguity of every
    plane the kernels read, and keeps their data pointers (and the
    tensors, so the pointers stay live). On the CPU it only keeps
    ``sten`` for the plain versions. A :class:`StepOperands` adds the
    operands that may change from call to call.
    """

    def __init__(self, sten):
        self.sten = sten
        ref = sten.valid
        self.device, self.dtype, self.shape = ref.device, ref.dtype, ref.shape
        self.on_cpu = _on_cpu(ref)
        if self.on_cpu:
            return
        if len(self.shape) != 2:
            raise ValueError(f"sten.valid must be 2-D, got shape"
                             f" {tuple(self.shape)}")
        R, C = self.shape
        tile = _tile()
        if R % tile[0] or C % tile[1]:
            raise ValueError(f"grid {(R, C)} is not a multiple of the"
                             f" kernels' {tile} tile")
        self.edge_shape = torch.Size((3, R, C))
        site, edge = self.shape, self.edge_shape
        self.psi_planes = (
            self.ptr("sten.w", sten.w, edge),
            *(self.ptr(f"sten.{n}", getattr(sten, n), site)
              for n in ("sym_diag", "inv_area", "fixed_mask", "valid")))
        self.rhs_planes = (self.ptr("sten.inv_len", sten.inv_len, edge),
                           self.ptr("sten.dual", sten.dual, edge))
        self.inv_area = self.psi_planes[2]

    def ptr(self, name, t, shape) -> int:
        return _check(name, t, shape, self.device, self.dtype)


class StepOperands:
    """The operands of both step kernels: a :class:`StencilOperands` and
    what may change from call to call (the link form ``U``, and ``dA_dt``
    and ``neumann_term``, which only :meth:`poisson_rhs` needs).

    ``sten`` is a :class:`StencilOperands`, or a stencil, which is then
    checked here. On the card each operand is checked once, when bound;
    :meth:`rebind` replaces some of them and checks only those, so a chunk
    whose operands are fixed binds once, and a step whose links, ``dA_dt``
    or Neumann term change rebinds just them. :meth:`psi_update` and
    :meth:`poisson_rhs` check only their per-call tensors.
    """

    def __init__(self, sten, U=None, dA_dt=None, neumann_term=None):
        if not isinstance(sten, StencilOperands):
            sten = StencilOperands(sten)
        self.stencil = sten
        self.sten = sten.sten
        self.device, self.dtype, self.shape = sten.device, sten.dtype, \
            sten.shape
        self.U = self.dA_dt = self.neumann_term = None
        self.factored, self.links = 0, None
        self.dA_ptr = self.neumann_ptr = None
        self._bind(U, dA_dt, neumann_term)

    def _bind(self, U, dA_dt, neumann_term) -> None:
        st = self.stencil
        if U is not None:
            self.U = U
            if not st.on_cpu:
                R, C = self.shape
                if isinstance(U, gs.FactoredLinkPhases):
                    self.factored = 1
                    self.links = (None, None,
                                  st.ptr("U.cf", U.cf, (3, R)),
                                  st.ptr("U.sf", U.sf, (3, R)),
                                  st.ptr("U.cg", U.cg, (3, C)),
                                  st.ptr("U.sg", U.sg, (3, C)))
                elif isinstance(U, gs.LinkPhases):
                    self.factored = 0
                    self.links = (st.ptr("U.ur", U.ur, st.edge_shape),
                                  st.ptr("U.ui", U.ui, st.edge_shape),
                                  None, None, None, None)
                else:
                    raise TypeError(f"unsupported link phases"
                                    f" {type(U).__name__}")
        if dA_dt is not None:
            self.dA_dt = dA_dt
            if not st.on_cpu:
                self.dA_ptr = st.ptr("dA_dt", dA_dt, st.edge_shape)
        if neumann_term is not None:
            self.neumann_term = neumann_term
            if not st.on_cpu:
                self.neumann_ptr = st.ptr("neumann_term", neumann_term,
                                          self.shape)

    def rebind(self, U=None, dA_dt=None, neumann_term=None
               ) -> "StepOperands":
        """A copy with the given operands replaced (None keeps one); only
        the replaced ones are checked."""
        new = copy.copy(self)
        new._bind(U, dA_dt, neumann_term)
        return new

    def _plane(self, name, t) -> int:
        return _check(name, t, self.shape, self.device, self.dtype)

    def _need_links(self) -> None:
        if self.U is None:
            raise ValueError("no link phases bound (StepOperands(..., U))")

    def _dt_ptr(self, dt):
        """``(pointer, tensor)`` of the device scalar dt (a float makes a
        one-element tensor, i.e. one fill on the device)."""
        if not isinstance(dt, torch.Tensor):
            dt = torch.full((), float(dt), dtype=self.dtype,
                            device=self.device)
        return _check("dt", dt.reshape(()), (), self.device, self.dtype), dt

    def psi_update(self, gamma: float, u: float, pr, pi, mu, epsilon, dt,
                   abs_sq=None) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
        """Fused covariant Laplacian + implicit-Euler psi update. The
        update's ``|psi|^2`` is ``abs_sq`` where given (the screening
        fixed point updates from its iterate with the step's starting
        ``|psi|^2``), else it is recomputed from ``pr``/``pi``. Returns
        ``(new_r, new_i, new_sq, ok)``, with ``ok`` a 0-d bool tensor on
        the tensors' device. One kernel launch, no other device work."""
        self._need_links()
        if _on_cpu(pr):
            return plain_psi_update(gamma, u, self.sten, self.U, pr, pi, mu,
                                    epsilon, dt, abs_sq)
        planes = (self._plane("pr", pr), self._plane("pi", pi),
                  None if abs_sq is None else self._plane("abs_sq", abs_sq),
                  self._plane("mu", mu), self._plane("epsilon", epsilon))
        # dt_keep holds a dt made here from a float until the launch.
        dt_ptr, dt_keep = self._dt_ptr(dt)
        out_r = torch.empty_like(pr)
        out_i = torch.empty_like(pr)
        out_sq = torch.empty_like(pr)
        ok = torch.empty((), dtype=torch.bool, device=pr.device)
        rc = _kernel("tdgl_psi_update", self.dtype)(
            *planes, *self.stencil.psi_planes, *self.links, self.factored,
            dt_ptr, float(gamma), float(u), out_r.data_ptr(),
            out_i.data_ptr(), out_sq.data_ptr(),
            _flag_word(pr.device).data_ptr(), ok.data_ptr(), self.shape[0],
            self.shape[1], torch.cuda.current_stream(pr.device).cuda_stream)
        _raise_on_error("fused_psi_update", rc)
        fused_psi_update.launches += 1
        return out_r, out_i, out_sq, ok

    def poisson_rhs(self, pr, pi, with_supercurrent: bool = False):
        """Fused ``poisson_rhs(sten, supercurrent_on_edges(sten, U, pr,
        pi), dA_dt, neumann_term)``. By default the edge currents never
        reach memory; ``with_supercurrent`` returns ``(rhs, J_s)``, the
        kernel writing the (3, rows, cols) supercurrent in the same pass
        (the screened step needs it)."""
        self._need_links()
        if self.dA_dt is None or self.neumann_term is None:
            raise ValueError("poisson_rhs needs operands bound with dA_dt"
                             " and neumann_term")
        if _on_cpu(pr):
            return plain_poisson_rhs(self.sten, self.U, pr, pi, self.dA_dt,
                                     self.neumann_term, with_supercurrent)
        psi = (self._plane("pr", pr), self._plane("pi", pi))
        st = self.stencil
        rhs = torch.empty_like(pr)
        J_s = (torch.empty(st.edge_shape, dtype=pr.dtype, device=pr.device)
               if with_supercurrent else None)
        rc = _kernel("tdgl_poisson_rhs", self.dtype)(
            *psi, *self.links, self.factored, *st.rhs_planes, self.dA_ptr,
            st.inv_area, self.neumann_ptr, rhs.data_ptr(),
            None if J_s is None else J_s.data_ptr(), self.shape[0],
            self.shape[1], torch.cuda.current_stream(pr.device).cuda_stream)
        _raise_on_error("fused_poisson_rhs", rc)
        fused_poisson_rhs.launches += 1
        return (rhs, J_s) if with_supercurrent else rhs


def fused_psi_update(gamma: float, u: float, sten, U, pr, pi, mu, epsilon,
                     dt, abs_sq=None) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
    """:meth:`StepOperands.psi_update` with ``(sten, U)`` bound for this
    call only."""
    return StepOperands(sten, U).psi_update(gamma, u, pr, pi, mu, epsilon,
                                            dt, abs_sq)


def fused_poisson_rhs(sten, U, pr, pi, dA_dt, neumann_term,
                      with_supercurrent: bool = False):
    """:meth:`StepOperands.poisson_rhs` with the operands bound for this
    call only."""
    return StepOperands(sten, U, dA_dt, neumann_term).poisson_rhs(
        pr, pi, with_supercurrent)


fused_psi_update.launches = 0
fused_poisson_rhs.launches = 0
KERNELS = (fused_psi_update, fused_poisson_rhs)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
