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
from tdgl_tpu_torch import convert
from tdgl_tpu_torch.models import gtdgl_stencil as gs
from tdgl_tpu_torch.ops import step_kernels
from tdgl_tpu_torch.testing import periodic_stencil

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


def _periodic(solver, dtype, seed=5):
    """The solver's stencil with every edge live (wrapped ones included),
    on the card, and seeded inputs that are nonzero on every site."""
    host = periodic_stencil(solver.host_sten, seed)
    sten = convert.stencil_to_torch(host, solver.torch_device)
    shape = solver.maps.shape
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.2, 1.0, shape)
    phase = rng.uniform(-np.pi, np.pi, shape)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=solver.torch_device)

    x = dict(pr=t(amp * np.cos(phase)), pi=t(amp * np.sin(phase)),
             mu=t(rng.normal(size=shape)), eps=t(np.ones(shape)),
             dA=t(rng.normal(size=(3,) + shape) * 0.05),
             neumann=t(rng.normal(size=shape) * 0.1))
    return sten, x


@pytest.mark.parametrize("stencil", ["real", "periodic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
def test_kernels_match_plain(cuda_device, mesh_device, dtype, form,
                             stencil):
    """On the solver's stencil, and on a periodic one where every wrapped
    edge carries weight: edge tiles must read the wrapped halo that
    torch.roll gives, not zeros."""
    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    U = _links(solver, state)[form]
    if stencil == "real":
        sten, x = solver.sten, _inputs(solver)
        x["neumann"] = state.neumann_term
    else:
        sten, x = _periodic(solver, solver.torch_dtype)
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = torch.tensor(1e-2, dtype=solver.torch_dtype, device=cuda_device)
    launches = step_kernels.fused_psi_update.launches
    got = step_kernels.fused_psi_update(g, u, sten, U, x["pr"], x["pi"],
                                        x["mu"], x["eps"], dt)
    ref = step_kernels.plain_psi_update(g, u, sten, U, x["pr"], x["pi"],
                                        x["mu"], x["eps"], dt)
    torch.cuda.synchronize()
    assert step_kernels.fused_psi_update.launches == launches + 1
    for a, b in zip(got[:3], ref[:3]):
        err = (a - b).abs().max().item()
        if dtype == "float32":
            assert err < 3e-5
        else:
            assert err < 1e-12 * max(b.abs().max().item(), 1.0)
    assert bool(got[3]) == bool(ref[3])
    rhs = step_kernels.fused_poisson_rhs(sten, U, x["pr"], x["pi"],
                                         x["dA"], x["neumann"])
    rhs_ref = step_kernels.plain_poisson_rhs(sten, U, x["pr"], x["pi"],
                                             x["dA"], x["neumann"])
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


def test_ok_flag_resets_between_calls(cuda_device, mesh_device):
    """Fail, pass, fail, pass through one bound operand set: the flag
    words reset themselves, and every ``ok`` agrees with the plain
    version."""
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    ops = step_kernels.StepOperands(solver.sten,
                                    _links(solver, state)["factored"])
    x = _inputs(solver, seed=4)
    g, u = solver.cfg.gamma, solver.cfg.u
    seen = []
    for dt, mu_scale in ((50.0, 40.0), (1e-5, 1.0), (50.0, 40.0),
                         (1e-5, 1.0)):
        dt_t = torch.tensor(dt, dtype=torch.float32, device=cuda_device)
        args = (x["pr"], x["pi"], mu_scale * x["mu"], x["eps"], dt_t)
        got = ops.psi_update(g, u, *args)[3]
        ref = step_kernels.plain_psi_update(g, u, solver.sten, ops.U,
                                            *args)[3]
        seen.append((bool(got), bool(ref)))
    assert seen == [(False, False), (True, True)] * 2


def test_nan_mu_fails_ok(cuda_device, mesh_device):
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    U = _links(solver, state)["factored"]
    x = _inputs(solver)
    site = int(solver.maps.site_flat[len(solver.maps.site_flat) // 2])
    mu = x["mu"].clone()
    mu.view(-1)[site] = float("nan")
    for m, ok in ((x["mu"], True), (mu, False)):
        args = (solver.cfg.gamma, solver.cfg.u, solver.sten, U, x["pr"],
                x["pi"], m, x["eps"], 1e-5)
        assert bool(step_kernels.plain_psi_update(*args)[3]) is ok
        assert bool(step_kernels.fused_psi_update(*args)[3]) is ok


def test_binding_rejects_bad_operands(cuda_device, mesh_device):
    """The grid must be a multiple of the kernels' tile, and every bound
    operand contiguous."""
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    U = _links(solver, state)["raw"]
    R, C = solver.maps.shape
    cut = solver.sten._replace(**{
        f: getattr(solver.sten, f)[..., :C - 8].contiguous()
        for f in ("valid", "w", "sym_diag", "inv_area", "fixed_mask")})
    with pytest.raises(ValueError, match="multiple"):
        step_kernels.StepOperands(cut, U)
    with pytest.raises(ValueError, match="contiguous"):
        step_kernels.StepOperands(
            solver.sten._replace(w=solver.sten.w.transpose(1, 2)
                                 .contiguous().transpose(1, 2)), U)
    with pytest.raises(ValueError, match="contiguous"):
        step_kernels.StepOperands(solver.sten, U, state.dA_dt,
                                  state.neumann_term.t().contiguous().t())


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


def test_solve_on_card_matches_cpu(mesh_device, cuda_device, tmp_path):
    """``TDGLSolver.solve()`` on the card: float64 at a fixed dt, the
    output file's last snapshot and dynamics against the same solve on
    the CPU (1e-10 relative), with every step through both kernels."""
    opts = dict(solve_time=0.04, dt_init=1e-3, adaptive=False, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    inputs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0))
    out = {}
    for where in ("cuda", "cpu"):
        solver = ttdgl.TDGLSolver(mesh_device, ttdgl.SolverOptions(
            output_file=str(tmp_path / f"{where}.h5"), **opts),
            torch_device=where, **inputs)
        step_kernels.reset_launch_counts()
        out[where] = solver.solve()
        if where == "cuda":
            launches = [fn.launches for fn in step_kernels.KERNELS]
            slots = ((out[where].data_range[1] + solver._failover_count)
                     * solver.chunk_size)
    card, host = out["cuda"], out["cpu"]
    assert launches[1] == slots and launches[0] >= slots
    assert card.data_range == host.data_range
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        a, b = getattr(card.tdgl_data, name), getattr(host.tdgl_data, name)
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), name
    assert np.abs(card.dynamics.mu - host.dynamics.mu).max() <= \
        1e-10 * np.abs(host.dynamics.mu).max()
    assert ttdgl.Solution.from_hdf5(card.path).equals(card)


@pytest.mark.parametrize("stencil", ["real", "periodic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
def test_supercurrent_form_and_abs_sq_match_plain(cuda_device, mesh_device,
                                                  dtype, form, stencil):
    """The RHS kernel's J_s-writing form against ``(poisson_rhs(sten, J_s,
    ...), J_s)``, and the psi kernel with a given ``|psi|^2`` plane."""
    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    U = _links(solver, state)[form]
    if stencil == "real":
        sten, x = solver.sten, _inputs(solver)
        x["neumann"] = state.neumann_term
    else:
        sten, x = _periodic(solver, solver.torch_dtype)
    launches = step_kernels.fused_poisson_rhs.launches
    rhs, J_s = step_kernels.fused_poisson_rhs(
        sten, U, x["pr"], x["pi"], x["dA"], x["neumann"],
        with_supercurrent=True)
    assert step_kernels.fused_poisson_rhs.launches == launches + 1
    rhs_ref, J_ref = step_kernels.plain_poisson_rhs(
        sten, U, x["pr"], x["pi"], x["dA"], x["neumann"],
        with_supercurrent=True)
    tol = 3e-5 if dtype == "float32" else 1e-12
    for got, ref in ((rhs, rhs_ref), (J_s, J_ref)):
        scale = max(ref.abs().max().item(), 1.0)
        assert (got - ref).abs().max().item() < tol * scale
    # A |psi|^2 plane that is not pr^2 + pi^2 (the screened iterate's).
    g, u = solver.cfg.gamma, solver.cfg.u
    sq = (x["pr"] ** 2 + x["pi"] ** 2) * 0.9
    args = (x["pr"], x["pi"], x["mu"], x["eps"], 1e-2)
    got = step_kernels.fused_psi_update(g, u, sten, U, *args, abs_sq=sq)
    ref = step_kernels.plain_psi_update(g, u, sten, U, *args, abs_sq=sq)
    for a, b in zip(got[:3], ref[:3]):
        err = (a - b).abs().max().item()
        assert err < (3e-5 if dtype == "float32"
                      else 1e-12 * max(b.abs().max().item(), 1.0))
    assert bool(got[3]) == bool(ref[3])


def test_rebinding_matches_fresh_operands(cuda_device, mesh_device):
    """Operands rebound call by call give what a fresh StepOperands of the
    same tensors gives, bit for bit."""
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    x = _inputs(solver)
    stencil = step_kernels.StencilOperands(solver.sten)
    base = step_kernels.StepOperands(stencil, None, state.dA_dt,
                                     state.neumann_term)
    g, u = solver.cfg.gamma, solver.cfg.u
    for scale in (0.5, 1.0, 2.0):
        A = state.A_applied * scale
        U = gs.edge_link_phases(solver.sten, A, shifted=False)
        dA = x["dA"] * scale
        neumann = state.neumann_term * scale
        ops = base.rebind(U=U, dA_dt=dA, neumann_term=neumann)
        fresh = step_kernels.StepOperands(solver.sten, U, dA, neumann)
        a = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"], 1e-2)
        b = fresh.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"], 1e-2)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        r1, j1 = ops.poisson_rhs(x["pr"], x["pi"], with_supercurrent=True)
        r2, j2 = fresh.poisson_rhs(x["pr"], x["pi"], with_supercurrent=True)
        assert torch.equal(r1, r2) and torch.equal(j1, j2)
    with pytest.raises(ValueError, match="contiguous"):
        base.rebind(neumann_term=state.neumann_term.t().contiguous().t())


def test_neumann_term_is_deterministic_on_card(cuda_device, mesh_device):
    solver = _solver(mesh_device, cuda_device, "float64")
    rng = np.random.default_rng(2)
    n_b = len(mesh_device.mesh.edge_mesh.boundary_edge_indices)
    mu_b = rng.normal(size=n_b)
    ref = solver._host_neumann_term(mu_b)
    mu_t = torch.tensor(mu_b, device=cuda_device)
    got = [gs.neumann_boundary_term(solver.sten, mu_t) for _ in range(10)]
    assert all(torch.equal(got[0], g) for g in got[1:])
    assert np.abs(got[0].cpu().numpy() - ref).max() <= \
        1e-15 * np.abs(ref).max()


@ttdgl.jittable
def _current_ramp(t):
    bias = 1.0 + 2.0 * torch.clamp(t * 10.0, max=1.0)
    return dict(source=bias, drain=-bias)


@pytest.mark.parametrize("case", ["traced", "screened-robust",
                                  "screened-fast"])
def test_dynamic_and_screened_chunks_match_cpu(cuda_device, mesh_device,
                                               case):
    """Float64 chunks on the card through both kernels against the same
    solver on the CPU, to 1e-10: a traced field and current ramp, and a
    screened chunk in the robust and in the fast program."""
    opts = dict(solve_time=1e9, dt_init=1e-4, adaptive=False, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    if case == "traced":
        kw = dict(applied_vector_potential=ttdgl.ConstantField(0.5)
                  * ttdgl.LinearRamp(tmin=0.0, tmax=1e-3),
                  terminal_currents=_current_ramp)
    else:
        opts.update(include_screening=True, screening_tolerance=1e-4,
                    screening_error_norm="global",
                    chunk_failover="off" if case == "screened-robust"
                    else "auto")
        kw = dict(applied_vector_potential=0.5)
    out = {}
    for where in ("cuda", "cpu"):
        solver = ttdgl.TDGLSolver(mesh_device, ttdgl.SolverOptions(**opts),
                                  torch_device=where, **kw)
        step_kernels.reset_launch_counts()
        state = solver._initial_state()
        if case == "screened-fast":
            state, outputs, _ = solver._fast_chunk_fn(
                solver.sten, solver.amg, state, solver._screening)
        else:
            state, outputs, _ = solver.chunk_fn(state)
        out[where] = (state, outputs,
                      [fn.launches for fn in step_kernels.KERNELS])
    (g, g_out, launches), (c, c_out, _) = out["cuda"], out["cpu"]
    assert launches[1] >= 20 and launches[0] >= 20
    assert int(g.step) == int(c.step)
    if case == "screened-fast":
        # Every slot launches both kernels once, frozen ones included (a
        # cold start trips the fast program's gate within the chunk).
        assert launches == [20, 20]
    else:
        assert int(g.step) == 20
    assert torch.equal(g_out.screening_iterations.cpu(),
                       c_out.screening_iterations)
    for name in ("psi_r", "psi_i", "mu", "A_induced", "A_applied",
                 "neumann_term"):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        assert (a - b).abs().max() <= 1e-10 * max(b.abs().max(), 1e-30), \
            name


@pytest.fixture(scope="module")
def ell_device():
    """The film of ``mesh_device`` on the default (Delaunay) mesh: the
    unstructured (ELL) backend."""
    layer = ttdgl.Layer(coherence_length=1.0, london_lambda=2.0,
                        thickness=0.1, conductivity=10.0)
    film = ttdgl.Polygon("film", points=ttdgl.box(14, 8)).resample(120)
    hole = ttdgl.Polygon("hole", points=ttdgl.circle(1.0, center=(2, 1)))
    source = ttdgl.Polygon("source", points=ttdgl.box(1, 6, center=(-7, 0)))
    drain = ttdgl.Polygon("drain", points=ttdgl.box(1, 6, center=(7, 0)))
    device = ttdgl.Device("ell", layer=layer, film=film, holes=[hole],
                          terminals=[source, drain],
                          probe_points=[(-4, 0), (4, 0)], length_units="um")
    device.make_mesh(min_points=400)
    return device


def _ell_case(case):
    opts = dict(solve_time=1e9, dt_init=1e-3, save_every=20,
                dtype="float64", field_units="mT", current_units="uA")
    kw = dict(applied_vector_potential=0.5,
              terminal_currents=dict(source=3.0, drain=-3.0))
    if case == "traced":
        kw = dict(applied_vector_potential=ttdgl.ConstantField(0.5)
                  * ttdgl.LinearRamp(tmin=0.0, tmax=1e-2),
                  terminal_currents=_current_ramp)
    elif case == "screened":
        opts.update(dt_init=1e-4, adaptive=False, save_every=10,
                    include_screening=True, screening_tolerance=1e-4,
                    screening_error_norm="global")
    return opts, kw


@pytest.mark.parametrize("case", ["static", "traced", "screened"])
def test_ell_chunk_on_card_matches_cpu(cuda_device, ell_device, case):
    """A float64 ELL chunk on the card against the same solver on the CPU,
    to 1e-10, with equal CG and screening iteration counts; the two CUDA
    step kernels are not launched (the ELL step has none)."""
    opts, kw = _ell_case(case)
    out = {}
    for where in ("cuda", "cpu"):
        solver = ttdgl.TDGLSolver(ell_device, ttdgl.SolverOptions(**opts),
                                  torch_device=where, **kw)
        assert not solver.structured
        step_kernels.reset_launch_counts()
        state, outputs, _ = solver.chunk_fn(solver._initial_state())
        out[where] = (state, outputs,
                      [fn.launches for fn in step_kernels.KERNELS])
    (g, g_out, launches), (c, c_out, _) = out["cuda"], out["cpu"]
    assert launches == [0, 0]
    assert int(g.step) == int(c.step) == opts["save_every"]
    for field in ("cg_iterations", "screening_iterations"):
        assert torch.equal(getattr(g_out, field).cpu(),
                           getattr(c_out, field)), field
    for name in ("psi", "mu", "supercurrent", "A_induced", "A_applied",
                 "mu_boundary"):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        assert (a - b).abs().max() <= 1e-10 * max(b.abs().max(), 1e-30), \
            name


def test_ell_float32_chunk_repeats_bitwise(cuda_device, ell_device):
    """A float32 ELL chunk (adaptive dt, AMG, tolerance-stopped CG) run 10
    times from one state gives bitwise-equal states: the Neumann term,
    the edge-to-site average and the AMG restriction are gathers in a
    fixed order, not atomics."""
    opts, kw = _ell_case("static")
    opts.update(dtype="float32")
    solver = ttdgl.TDGLSolver(ell_device, ttdgl.SolverOptions(**opts),
                              torch_device=cuda_device, **kw)
    start = solver._initial_state()
    runs = [solver.chunk_fn(start) for _ in range(10)]
    for state, outputs, _ in runs[1:]:
        for name in ("psi", "mu", "supercurrent", "normal_current"):
            assert torch.equal(getattr(state, name),
                               getattr(runs[0][0], name)), name
        assert torch.equal(outputs.cg_iterations, runs[0][1].cg_iterations)
        assert torch.equal(outputs.dt, runs[0][1].dt)


def test_ell_solve_on_card(cuda_device, ell_device, tmp_path):
    """``solve()`` on an unstructured mesh on the card: its re-read
    ``Solution`` ``.equals`` it, and a site limit far below the mesh
    (``unstructured_tpu_site_limit``) keeps every tensor on the card."""
    opts = dict(solve_time=0.04, dt_init=1e-3, adaptive=False, save_every=20,
                dtype="float64", field_units="mT", current_units="uA",
                unstructured_tpu_site_limit=10,
                output_file=str(tmp_path / "ell.h5"))
    solver = ttdgl.TDGLSolver(ell_device, ttdgl.SolverOptions(**opts),
                              applied_vector_potential=0.5,
                              terminal_currents=dict(source=3.0, drain=-3.0),
                              torch_device=cuda_device)
    state = solver._initial_state()
    tensors = list(solver.op) + list(solver.amg) + list(state)
    assert all(t.device.type == "cuda" for t in tensors)
    solution = solver.solve()
    assert solution.data_range[1] >= 2
    assert np.isfinite(solution.tdgl_data.psi).all()
    assert ttdgl.Solution.from_hdf5(solution.path).equals(solution)


def test_resume_on_card_is_bitwise(mesh_device, cuda_device, tmp_path):
    """A float32 run resumed on the card from its own checkpoint equals the
    uninterrupted run on the card bit for bit, and the resumed run goes
    through both kernels every step slot."""
    inputs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0))

    def run(solve_time, name, resume_from=None):
        solver = ttdgl.TDGLSolver(mesh_device, ttdgl.SolverOptions(
            solve_time=solve_time, dt_init=1e-4, dt_max=1e-2, save_every=20,
            field_units="mT", current_units="uA",
            output_file=str(tmp_path / name)),
            torch_device=cuda_device, **inputs)
        chunk_fn, calls = solver.chunk_fn, []

        def counted(state):
            calls.append(1)
            return chunk_fn(state)

        solver.chunk_fn = counted
        step_kernels.reset_launch_counts()
        solution = solver.solve(resume_from=resume_from)
        # Step slots: every chunk call, robust re-runs included.
        slots = (len(calls) + solver._failover_count) * solver.chunk_size
        return solution, slots

    full, _ = run(0.4, "full.h5")
    part, _ = run(0.2, "part.h5")
    resumed, slots = run(0.4, "resumed.h5", resume_from=part.path)
    launches = [fn.launches for fn in step_kernels.KERNELS]
    assert launches[1] == slots
    assert launches[0] >= launches[1]
    for name in ("psi", "mu"):
        assert np.array_equal(getattr(resumed.tdgl_data, name),
                              getattr(full.tdgl_data, name)), name
    for key in ("step", "time", "dt"):
        assert resumed.tdgl_data.state[key] == full.tdgl_data.state[key]


def test_cpu_checkpoint_resumes_on_card(mesh_device, cuda_device, tmp_path):
    """A float64 checkpoint written on the CPU resumes on the card and on
    the CPU alike (1e-10 relative, equal steps)."""
    opts = dict(dt_init=1e-3, adaptive=False, save_every=20, dtype="float64",
                field_units="mT", current_units="uA")
    inputs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0))
    part = ttdgl.solve(mesh_device, ttdgl.SolverOptions(
        solve_time=0.02, output_file=str(tmp_path / "part.h5"), **opts),
        torch_device="cpu", **inputs)
    out = {}
    for where in ("cuda", "cpu"):
        out[where] = ttdgl.solve(mesh_device, ttdgl.SolverOptions(
            solve_time=0.04, output_file=str(tmp_path / f"{where}.h5"),
            **opts), torch_device=where, resume_from=part.path, **inputs)
    card, host = out["cuda"], out["cpu"]
    assert card.tdgl_data.state["step"] == host.tdgl_data.state["step"] > 21
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        a, b = getattr(card.tdgl_data, name), getattr(host.tdgl_data, name)
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), name


def _member_inputs(solver, B, seed=11):
    """B members' psi, mu and Neumann planes (``(B, rows, cols)``), each
    member seeded on its own."""
    xs = [_inputs(solver, seed + b) for b in range(B)]
    rng = np.random.default_rng(seed)
    neumann = torch.tensor(rng.normal(size=(B,) + solver.maps.shape) * 0.1,
                           dtype=solver.torch_dtype,
                           device=solver.torch_device)
    return {k: torch.stack([x[k] for x in xs]) for k in xs[0]} | {
        "neumann": neumann}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
@pytest.mark.parametrize("links", ["per member", "shared"])
def test_batched_kernels_match_plain_per_member(cuda_device, mesh_device,
                                                dtype, form, links):
    """A batch of 3 members in one launch of each kernel: every member
    equals the plain version on its own inputs, with the links per member
    (a field sweep: scaled A) or shared (a current sweep), dt per member,
    epsilon and dA/dt shared, the Neumann plane per member."""
    B = 3
    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    scales = torch.tensor([0.5, 1.0, 2.0], dtype=solver.torch_dtype,
                          device=cuda_device)
    if links == "per member":
        A = state.A_applied[None] * scales[:, None, None, None, None]
    else:
        A = state.A_applied
    U = _links(solver, state._replace(A_applied=A))[form]
    x = _member_inputs(solver, B)
    eps, dA = _inputs(solver)["eps"], _inputs(solver)["dA"]
    dt = torch.tensor([1e-2, 3e-3, 2e-2], dtype=solver.torch_dtype,
                      device=cuda_device)
    g, u = solver.cfg.gamma, solver.cfg.u
    ops = step_kernels.StepOperands(solver.sten, U, dA, x["neumann"])
    before = [fn.launches for fn in step_kernels.KERNELS]
    got = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], eps, dt)
    rhs = ops.poisson_rhs(x["pr"], x["pi"])
    assert [fn.launches - b for fn, b in
            zip(step_kernels.KERNELS, before)] == [1, 1]
    assert got[3].shape == (B,)
    tol = 3e-5 if dtype == "float32" else 1e-12
    for b in range(B):
        U_b = type(U)(*(f[b] for f in U)) if links == "per member" else U
        ref = step_kernels.plain_psi_update(g, u, solver.sten, U_b,
                                            x["pr"][b], x["pi"][b],
                                            x["mu"][b], eps, dt[b])
        for a, r in zip(got[:3], ref[:3]):
            scale = 1.0 if dtype == "float32" else max(
                r.abs().max().item(), 1.0)
            assert (a[b] - r).abs().max().item() < tol * scale
        assert bool(got[3][b]) == bool(ref[3])
        rhs_ref = step_kernels.plain_poisson_rhs(
            solver.sten, U_b, x["pr"][b], x["pi"][b], dA, x["neumann"][b])
        scale = max(rhs_ref.abs().max().item(), 1.0)
        assert (rhs[b] - rhs_ref).abs().max().item() < tol * scale


def test_single_member_batch_equals_single_call(cuda_device, mesh_device):
    """B = 1 through the batched entry launches the same kernels as a
    single run: bitwise equal outputs."""
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    U = _links(solver, state)["factored"]
    x = _inputs(solver)
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = torch.tensor(1e-2, dtype=torch.float32, device=cuda_device)
    ops = step_kernels.StepOperands(solver.sten, U, x["dA"],
                                    state.neumann_term)
    single = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"], dt)
    batch = ops.psi_update(g, u, x["pr"][None], x["pi"][None],
                           x["mu"][None], x["eps"], dt.reshape(1))
    for a, b in zip(single, batch):
        assert torch.equal(a, b[0])
    assert torch.equal(ops.poisson_rhs(x["pr"], x["pi"]),
                       ops.poisson_rhs(x["pr"][None], x["pi"][None])[0])


def test_ok_is_per_member(cuda_device, mesh_device):
    """Members 1 and 5 of 8 get a dt far too large: only their ``ok`` is
    False; the next launch, all passing, reads all True (each member's
    flag word reset itself)."""
    B = 8
    solver = _solver(mesh_device, cuda_device, "float32")
    state = solver._initial_state()
    ops = step_kernels.StepOperands(solver.sten,
                                    _links(solver, state)["factored"])
    x = _member_inputs(solver, B, seed=4)
    g, u = solver.cfg.gamma, solver.cfg.u
    bad = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    bad[[1, 5]] = True
    dt = torch.where(bad, 50.0, 1e-5).to(torch.float32)
    mu = x["mu"] * torch.where(bad, 40.0, 1.0)[:, None, None]
    ok = ops.psi_update(g, u, x["pr"], x["pi"], mu, x["eps"][0], dt)[3]
    ref = step_kernels.plain_psi_update(g, u, solver.sten, ops.U, x["pr"],
                                        x["pi"], mu, x["eps"][0], dt)[3]
    assert ok.tolist() == ref.tolist() == [True, False, True, True, True,
                                           False, True, True]
    ok = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], x["eps"][0],
                        torch.full((B,), 1e-5, device=cuda_device))[3]
    assert ok.tolist() == [True] * B


def test_sweep_on_card_matches_cpu(cuda_device, mesh_device):
    """A float64 3-member current sweep through ``solve_sweep`` on the card
    (one launch of each kernel per step for the batch) tracks the same
    sweep on the CPU over 20 steps to 1e-10, the bound of the single-run
    chunk test above (fused multiply-adds round differently on the card;
    after 50 steps the difference had grown to 1.1e-10)."""
    from tdgl_tpu_torch.parallel import solve_sweep

    options = ttdgl.SolverOptions(solve_time=0.02, dt_init=1e-3,
                                  save_every=20, field_units="mT",
                                  current_units="uA", dtype="float64")
    kwargs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0),
                  current_scales=[0.5, 1.0, 2.0])
    step_kernels.reset_launch_counts()
    gpu = solve_sweep(mesh_device, options, **kwargs)
    launches = [fn.launches for fn in step_kernels.KERNELS]
    cpu = solve_sweep(mesh_device, options, torch_device="cpu", **kwargs)
    assert np.array_equal(gpu.steps, cpu.steps)
    assert launches[1] >= int(gpu.steps.max()) and launches[0] >= launches[1]
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), name
    assert np.abs(gpu.dynamics_dt - cpu.dynamics_dt).max() <= 1e-12


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
def test_batched_screened_forms_match_plain_per_member(cuda_device,
                                                       mesh_device, dtype,
                                                       form):
    """The two kernel forms a screened batch launches, at 3 members with
    per-member links: the RHS kernel's J_s-writing form (J_s ``(B, 3,
    rows, cols)``) and the psi kernel with a per-member ``|psi|^2`` plane
    ``(B, rows, cols)``; one launch each, every member equal to the plain
    version on its own inputs."""
    B = 3
    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    scales = torch.tensor([0.5, 1.0, 2.0], dtype=solver.torch_dtype,
                          device=cuda_device)
    A = state.A_applied[None] * scales[:, None, None, None, None]
    U = _links(solver, state._replace(A_applied=A))[form]
    x = _member_inputs(solver, B, seed=7)
    eps, dA = _inputs(solver)["eps"], _inputs(solver)["dA"]
    # Steps short enough that |psi| stays near 1 on these random inputs
    # (where the float32 pin of 3e-5 absolute was set).
    dt = torch.tensor([1e-3, 3e-4, 2e-3], dtype=solver.torch_dtype,
                      device=cuda_device)
    sq = (x["pr"] ** 2 + x["pi"] ** 2) * torch.tensor(
        [0.9, 1.0, 1.1], dtype=solver.torch_dtype,
        device=cuda_device)[:, None, None]
    g, u = solver.cfg.gamma, solver.cfg.u
    ops = step_kernels.StepOperands(solver.sten, U, dA, x["neumann"])
    before = [fn.launches for fn in step_kernels.KERNELS]
    got = ops.psi_update(g, u, x["pr"], x["pi"], x["mu"], eps, dt, sq)
    rhs, J_s = ops.poisson_rhs(x["pr"], x["pi"], with_supercurrent=True)
    assert [fn.launches - b for fn, b in
            zip(step_kernels.KERNELS, before)] == [1, 1]
    assert J_s.shape == (B, 3) + tuple(solver.maps.shape)
    tol = 3e-5 if dtype == "float32" else 1e-12
    for b in range(B):
        U_b = type(U)(*(f[b] for f in U))
        ref = step_kernels.plain_psi_update(g, u, solver.sten, U_b,
                                            x["pr"][b], x["pi"][b],
                                            x["mu"][b], eps, dt[b], sq[b])
        for a, r in zip(got[:3], ref[:3]):
            scale = 1.0 if dtype == "float32" else max(
                r.abs().max().item(), 1.0)
            assert (a[b] - r).abs().max().item() < tol * scale
        assert bool(got[3][b]) == bool(ref[3])
        rhs_ref, J_ref = step_kernels.plain_poisson_rhs(
            solver.sten, U_b, x["pr"][b], x["pi"][b], dA, x["neumann"][b],
            with_supercurrent=True)
        for a, r in ((rhs[b], rhs_ref), (J_s[b], J_ref)):
            scale = max(r.abs().max().item(), 1.0)
            assert (a - r).abs().max().item() < tol * scale


def test_screened_sweep_on_card_matches_cpu(cuda_device, mesh_device):
    """A float64 3-member screened field sweep through ``solve_sweep`` on
    the card (the J_s and ``abs_sq`` forms with per-member links, once per
    fixed-point iteration for the batch) against the same sweep on the
    CPU over 21 steps of fixed dt: 1e-10, equal steps."""
    from tdgl_tpu_torch.parallel import solve_sweep

    options = ttdgl.SolverOptions(
        solve_time=0.002, dt_init=1e-4, adaptive=False, save_every=20,
        field_units="mT", current_units="uA", dtype="float64",
        include_screening=True,
        screening_tolerance=1e-4, screening_error_norm="global")
    kwargs = dict(applied_vector_potential=0.5,
                  terminal_currents=dict(source=3.0, drain=-3.0),
                  field_scales=[0.5, 1.0, 2.0], output_dir=None)
    step_kernels.reset_launch_counts()
    gpu = solve_sweep(mesh_device, options, **kwargs)
    launches = [fn.launches for fn in step_kernels.KERNELS]
    cpu = solve_sweep(mesh_device, options, torch_device="cpu", **kwargs)
    assert np.array_equal(gpu.steps, cpu.steps) and not gpu.failed.any()
    assert launches[1] > int(gpu.steps.max()) and launches[0] >= launches[1]
    for name in ("psi", "mu", "supercurrent", "normal_current"):
        a, b = getattr(gpu, name), getattr(cpu, name)
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), name
    assert np.abs(gpu.dynamics_dt - cpu.dynamics_dt).max() <= 1e-12


@pytest.mark.parametrize("stencil", ["real", "periodic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["raw", "factored"])
def test_row_block_kernels_match_plain(cuda_device, mesh_device, dtype,
                                       form, stencil):
    """Each kernel on row blocks with halos (4 blocks on the card, one
    launch per block) against its plain version on the whole grid: the
    psi update with its ``ok`` (AND over blocks), and the RHS in both
    forms. The periodic stencil puts weight on the wrapped edges between
    the last block and the first."""
    from tdgl_tpu_torch.ops import rowblocks

    solver = _solver(mesh_device, cuda_device, dtype)
    state = solver._initial_state()
    U = _links(solver, state)[form]
    if stencil == "real":
        sten, x = solver.sten, _inputs(solver)
        x["neumann"] = state.neumann_term
    else:
        sten, x = _periodic(solver, solver.torch_dtype)
    layout = rowblocks.row_layout(solver.maps.shape[0], [cuda_device] * 4)

    def split(v):
        return rowblocks.split(v, layout, -2)

    bsten = type(sten)(*(split(v) if v.dim() >= 2 and v.shape[-2:] ==
                         sten.valid.shape else v for v in sten))
    if form == "raw":
        bU = gs.LinkPhases(split(U.ur), split(U.ui), None, None)
    else:
        bU = gs.FactoredLinkPhases(rowblocks.split(U.cf, layout, -1),
                                   rowblocks.split(U.sf, layout, -1),
                                   U.cg, U.sg)
    ops = rowblocks.RowStepOperands(bsten, bU, split(x["dA"]),
                                    split(x["neumann"]))
    g, u = solver.cfg.gamma, solver.cfg.u
    dt = torch.tensor(1e-2, dtype=solver.torch_dtype, device=cuda_device)
    launches = step_kernels.fused_psi_update.launches
    got = ops.psi_update(g, u, split(x["pr"]), split(x["pi"]),
                         split(x["mu"]), split(x["eps"]), dt)
    ref = step_kernels.plain_psi_update(g, u, sten, U, x["pr"], x["pi"],
                                        x["mu"], x["eps"], dt)
    torch.cuda.synchronize()
    assert step_kernels.fused_psi_update.launches == launches + 4
    tol = 3e-5 if dtype == "float32" else 1e-12
    for a, b in zip(got[:3], ref[:3]):
        a = rowblocks.gather(a)
        assert (a - b).abs().max().item() < tol * max(
            b.abs().max().item(), 1.0)
    assert bool(got[3]) == bool(ref[3])
    rhs, J_s = ops.poisson_rhs(split(x["pr"]), split(x["pi"]),
                               with_supercurrent=True)
    rhs_ref, J_ref = step_kernels.plain_poisson_rhs(
        sten, U, x["pr"], x["pi"], x["dA"], x["neumann"],
        with_supercurrent=True)
    for a, b in ((rhs, rhs_ref), (J_s, J_ref)):
        a = rowblocks.gather(a)
        assert (a - b).abs().max().item() < tol * max(
            b.abs().max().item(), 1.0)


def test_sharded_chunk_on_card_matches_cpu(cuda_device, mesh_device):
    """A float64 chunk over 4 row blocks on the card against the
    unsharded chunk on the CPU (1e-12 relative)."""
    from tdgl_tpu_torch.parallel import (shard_solver_spatially,
                                         spatial_device_mesh)

    opts = dict(dtype="float64", dt_init=1e-3, adaptive=False,
                poisson_tolerance=1e-12)
    card = _solver(mesh_device, cuda_device, **opts)
    place = shard_solver_spatially(card, spatial_device_mesh(
        [cuda_device] * 4))
    launches = step_kernels.fused_psi_update.launches
    _, _, got = card.chunk_fn(place(card._initial_state()))
    assert step_kernels.fused_psi_update.launches - launches == 4 * 20
    cpu = _solver(mesh_device, "cpu", **opts)
    _, _, ref = cpu.chunk_fn(cpu._initial_state())
    for k in ("psi_real", "psi_imag", "mu"):
        a, b = got[k].cpu(), ref[k]
        assert (a - b).abs().max().item() < 1e-12 * b.abs().max().item()


def test_pencil_fft_screening_on_card(cuda_device):
    """The pencil-decomposed FFT screening on 4 row blocks of the card
    against the whole-grid FFT, float64 1e-12 relative."""
    import types

    from tdgl_tpu_torch.ops import fft_screening as fs
    from tdgl_tpu_torch.ops import rowblocks
    from tdgl_tpu_torch.parallel import fft_sharded, spatial_device_mesh

    Rp, Cp = 64, 96
    rng = np.random.default_rng(21)
    ghat = np.fft.rfft2(rng.normal(size=(3, 2 * Rp, 2 * Cp)), axes=(1, 2))
    g0hat = np.fft.rfft2(rng.normal(size=(2 * Rp, 2 * Cp)))
    fft_data = fs.FFTScreeningData(
        Ghat=torch.tensor(ghat, device=cuda_device),
        G0hat=torch.tensor(g0hat, device=cuda_device))
    sten = types.SimpleNamespace(edge_valid=torch.tensor(
        (rng.uniform(size=(3, Rp, Cp)) > 0.2).astype(np.float64),
        device=cuda_device))
    J = torch.tensor(rng.normal(size=(Rp, Cp, 2)), device=cuda_device)
    ref = fs.induced_vector_potential_fft(fft_data, sten, J)

    mesh = spatial_device_mesh([cuda_device] * 4)
    eval_fn = fft_sharded.make_sharded_fft_screening(mesh, Rp, Cp)
    padded = fft_sharded.pad_fft_data_for_sharding(fft_data, 4, mesh)
    assert [t.shape[-1] for t in padded.Ghat] == [25] * 4
    layout = rowblocks.row_layout(Rp, mesh.devices)
    got = eval_fn(padded, types.SimpleNamespace(
        edge_valid=rowblocks.split(sten.edge_valid, layout, -2)),
        rowblocks.split(J, layout, -3))
    assert all(b.is_cuda for b in got.blocks)
    got = rowblocks.gather(got)
    assert (got - ref).abs().max().item() < 1e-12 * ref.abs().max().item()
