"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. This file imports neither jax nor tdgl_tpu, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)
Tolerances: float32 3e-5 absolute for psi and 3e-5 times the RHS scale
for the RHS (the CPU pins of ``tests/test_pallas_step.py``); float64
1e-12 relative (the same arithmetic, up to fused multiply-adds).
"""

import numpy as np
import pytest
import torch

import tdgl_tpu_torch as ttdgl
from tdgl_tpu_torch.models import gtdgl_stencil as gs
from tdgl_tpu_torch.ops import step_kernels

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh_device():
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(14, 8)).resample(200)
    hole = ttdgl.Polygon("hole", points=ttdgl.circle(1.0, center=(2, 1)))
    source = ttdgl.Polygon("source", points=ttdgl.box(1, 6, center=(-7, 0)))
    drain = ttdgl.Polygon("drain", points=ttdgl.box(1, 6, center=(7, 0)))
    device = ttdgl.Device("cu", layer=layer, film=film, holes=[hole],
                          terminals=[source, drain],
                          probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=700, structured=True)
    return device


def _solver(mesh_device, cuda_device, dtype, **options):
    opts = dict(solve_time=1e9, field_units="mT", current_units="uA",
                dtype=dtype, factor_link_phases=True, save_every=20,
                steps_per_chunk=20)
    opts.update(options)
    return ttdgl.TDGLSolver(mesh_device, ttdgl.SolverOptions(**opts),
                            applied_vector_potential=0.5,
                            terminal_currents=dict(source=3.0, drain=-3.0),
                            torch_device=cuda_device)


def _inputs(solver, seed=3):
    shape = solver.maps.shape
    td = solver.torch_dtype
    valid = np.asarray(solver.host_sten.valid)
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.0, 1.0, shape)
    phase = rng.uniform(-np.pi, np.pi, shape)

    def t(a):
        return torch.tensor(a, dtype=td, device=solver.torch_device)

    return dict(
        pr=t(amp * np.cos(phase) * valid), pi=t(amp * np.sin(phase) * valid),
        mu=t(rng.normal(size=shape) * valid),
        eps=t(np.ones(shape) * valid),
        dA=t(rng.normal(size=(3,) + shape) * 0.05
             * np.asarray(solver.host_sten.edge_valid)),
    )


def _links(solver, state):
    return {"raw": gs.edge_link_phases(solver.sten, state.A_applied),
            "factored": gs.factor_link_phases(solver.sten, state.A_applied)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
def test_kernels_match_plain(cuda_device, mesh_device, dtype, form):
    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    U = _links(solver, state)[form]
    x = _inputs(solver)
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = torch.tensor(1e-2, dtype=solver.torch_dtype, device=cuda_device)
    launches = step_kernels.fused_psi_update.launches
    got = step_kernels.fused_psi_update(g, u, solver.sten, U, x["pr"],
                                        x["pi"], x["mu"], x["eps"], dt)
    ref = step_kernels.plain_psi_update(g, u, solver.sten, U, x["pr"],
                                        x["pi"], x["mu"], x["eps"], dt)
    torch.cuda.synchronize()
    assert step_kernels.fused_psi_update.launches == launches + 1
    for a, b in zip(got[:3], ref[:3]):
        err = (a - b).abs().max().item()
        if dtype == "float32":
            assert err < 3e-5
        else:
            assert err < 1e-12 * max(b.abs().max().item(), 1.0)
    assert bool(got[3]) == bool(ref[3])
    rhs = step_kernels.fused_poisson_rhs(solver.sten, U, x["pr"], x["pi"],
                                         x["dA"], state.neumann_term)
    rhs_ref = step_kernels.plain_poisson_rhs(solver.sten, U, x["pr"],
                                             x["pi"], x["dA"],
                                             state.neumann_term)
    scale = max(rhs_ref.abs().max().item(), 1.0)
    tol = 3e-5 if dtype == "float32" else 1e-12
    assert (rhs - rhs_ref).abs().max().item() < tol * scale


def test_bad_flag_matches_plain(cuda_device, mesh_device):
    """A huge dt drives discriminants negative: ``ok`` agrees."""
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    U = _links(solver, state)["factored"]
    x = _inputs(solver, seed=4)
    args = (solver.cfg.gamma, solver.cfg.u, solver.sten, U, x["pr"],
            x["pi"], 40.0 * x["mu"], x["eps"], 50.0)
    got = step_kernels.fused_psi_update(*args)
    ref = step_kernels.plain_psi_update(*args)
    assert not bool(ref[3])
    assert bool(got[3]) == bool(ref[3])


def test_wrappers_reject_bad_operands(cuda_device, mesh_device):
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    U = _links(solver, state)["raw"]
    x = _inputs(solver)
    with pytest.raises(TypeError):
        step_kernels.fused_poisson_rhs(solver.sten, U, x["pr"].double(),
                                       x["pi"].double(), x["dA"],
                                       state.neumann_term)
    with pytest.raises(ValueError):
        step_kernels.fused_poisson_rhs(solver.sten, U, x["pr"].t(),
                                       x["pi"], x["dA"], state.neumann_term)


def test_chunk_runs_through_kernels_and_matches_cpu(cuda_device,
                                                    mesh_device):
    """A float64 chunk on the card launches both kernels every step and
    tracks the CPU (plain) run of the same solver to 1e-10."""
    gpu = _solver(mesh_device, cuda_device, "float64", adaptive=False,
                  dt_init=1e-3)
    cpu = ttdgl.TDGLSolver(mesh_device, gpu.options,
                           applied_vector_potential=0.5,
                           terminal_currents=dict(source=3.0, drain=-3.0),
                           torch_device="cpu")
    step_kernels.reset_launch_counts()
    g_state, _, _ = gpu.chunk_fn(gpu._initial_state())
    c_state, _, _ = cpu.chunk_fn(cpu._initial_state())
    assert step_kernels.fused_psi_update.launches >= 20
    assert step_kernels.fused_poisson_rhs.launches == 20
    assert int(g_state.step) == int(c_state.step) == 20
    for name in ("psi_r", "psi_i", "mu"):
        a = getattr(g_state, name).cpu()
        b = getattr(c_state, name)
        assert (a - b).abs().max() <= 1e-10 * b.abs().max(), name
