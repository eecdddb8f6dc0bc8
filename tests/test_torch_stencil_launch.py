"""A kernel wrapper given CPU tensors runs its plain version and launches
nothing.

The fixtures are in ``tests/test_torch_stencil.py``.
"""

from tdgl_tpu_torch.ops import step_kernels

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_stencil import (_psi_args, _t, case, device,
                                one_blas_thread)


def test_cpu_tensors_do_not_launch(case):
    """On CPU tensors the wrappers run their plain versions: the launch
    counters stay at 0 and no kernel library is loaded."""
    from tdgl_tpu_torch.ops import kernel_build

    step_kernels.reset_launch_counts()
    solver = case["solver"]
    for form in ("raw", "factored"):
        step_kernels.fused_psi_update(
            solver.cfg.gamma, solver.cfg.u, case["tsten"], case["tU"][form],
            *_psi_args(case), 1e-2)
        step_kernels.fused_poisson_rhs(
            case["tsten"], case["tU"][form], _t(case, "pr"), _t(case, "pi"),
            _t(case, "dA"), _t(case, "neumann"))
    assert step_kernels.fused_psi_update.launches == 0
    assert step_kernels.fused_poisson_rhs.launches == 0
    assert kernel_build._lib is None
