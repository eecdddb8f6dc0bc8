from .cg import CGResult, cg_solve, cg_solve_fixed, cg_solve_topup
