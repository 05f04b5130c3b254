"""ILP formulation of the S1 optimisation problem (paper Sec 5).

Decision variables (Table 1), binary:
    P_g[i,k]        patch i assigned to group k               (eq. 2)
    pxl_g[j,k]      pixel j present in group k                (eq. 5)
    pxl_ovlp[j,k]   pixel j in groups k and k-1               (eq. 7)
and the derived  pxl_I[j,k] = pxl_g[j,k] - pxl_ovlp[j,k]      (eq. 8)
which is *eliminated by substitution*: since pxl_ovlp <= pxl_g always holds
(eq. 7 linearisation) the AND-with-negation of eq. 8 is exactly the linear
difference, so pxl_I never needs its own column.  This shrinks the model by
J*K binaries relative to the literal formulation.

Constraints:
    eq. 3   each patch in exactly one group
    eq. 4   group cardinality <= nb_patches_max_S1
    eq. 6   pxl_g = OR_i P_g  (linearised: >= each, <= sum)
    eq. 7   pxl_ovlp = AND    (linearised; only the two upper bounds are
            needed — the objective and eq. 9 both press pxl_ovlp upward)
    eq. 9   sum_k pxl_I[j,k] <= nb_data_reload
    eq. 12  on-chip memory capacity (optional; element units, see DESIGN §6)

Objective (eq. 15):  min t_l * sum_{j,k} pxl_I[j,k]  (+ K * t_acc const).

The search space is restricted to K = K_min groups as in Sec 7.1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.strategies import GroupedStrategy, k_min


@dataclasses.dataclass
class IlpModel:
    """The assembled MILP in scipy (HiGHS) form."""

    spec: ConvSpec
    p: int                      # nb_patches_max_S1
    k: int                      # number of groups
    pixels: list[int]           # covered pixel ids (column order)
    c: np.ndarray               # objective vector
    a: sparse.csr_matrix        # constraint matrix
    lb: np.ndarray
    ub: np.ndarray
    n_pg: int                   # number of P_g columns
    n_px: int                   # number of pxl columns per family

    @property
    def num_vars(self) -> int:
        return len(self.c)

    def pg_col(self, i: int, k: int) -> int:
        return i * self.k + k

    def g_col(self, jx: int, k: int) -> int:
        return self.n_pg + jx * self.k + k

    def o_col(self, jx: int, k: int) -> int:
        return self.n_pg + self.n_px + jx * self.k + k

    def extract_groups(self, x: np.ndarray) -> GroupedStrategy:
        """Solution vector -> ordered patch groups."""
        groups: list[list[int]] = [[] for _ in range(self.k)]
        for i in range(self.spec.num_patches):
            for k in range(self.k):
                if x[self.pg_col(i, k)] > 0.5:
                    groups[k].append(i)
                    break
        return GroupedStrategy(
            "ilp", self.spec, tuple(tuple(g) for g in groups if g))


def build_ilp(spec: ConvSpec, p: int, k: int | None = None,
              nb_data_reload: int = 2,
              size_mem: int | None = None) -> IlpModel:
    """Assemble the Sec-5 MILP for ``spec`` with group capacity ``p``."""
    if k is None:
        k = k_min(spec, p)
    x_count = spec.num_patches
    pixels = spec.pixels_of_mask(spec.all_pixels_mask)
    jx_of = {j: jx for jx, j in enumerate(pixels)}
    j_count = len(pixels)
    n_pg = x_count * k
    n_px = j_count * k
    n_vars = n_pg + 2 * n_px

    # covering patches per pixel (from the pxl_in_P constant, Sec 5.1)
    cover: list[list[int]] = [[] for _ in range(j_count)]
    for i in range(x_count):
        for j in spec.pixels_of_mask(spec.patch_masks[i]):
            cover[jx_of[j]].append(i)

    model = IlpModel(spec=spec, p=p, k=k, pixels=pixels,
                     c=np.zeros(n_vars), a=None, lb=None, ub=None,
                     n_pg=n_pg, n_px=n_px)

    rows, cols, vals = [], [], []
    con_lb, con_ub = [], []
    r = 0

    def add(entries, lo, hi):
        nonlocal r
        for c_, v_ in entries:
            rows.append(r)
            cols.append(c_)
            vals.append(v_)
        con_lb.append(lo)
        con_ub.append(hi)
        r += 1

    # eq. 3: sum_k P_g[i,k] == 1
    for i in range(x_count):
        add([(model.pg_col(i, kk), 1.0) for kk in range(k)], 1.0, 1.0)

    # eq. 4: sum_i P_g[i,k] <= p
    for kk in range(k):
        add([(model.pg_col(i, kk), 1.0) for i in range(x_count)],
            0.0, float(p))

    # eq. 6 linearisation
    for jx in range(j_count):
        for kk in range(k):
            gcol = model.g_col(jx, kk)
            # pxl_g >= P_g[i,k]  for every covering patch i
            for i in cover[jx]:
                add([(model.pg_col(i, kk), 1.0), (gcol, -1.0)],
                    -np.inf, 0.0)
            # pxl_g <= sum_i P_g[i,k]
            add([(gcol, 1.0)] + [(model.pg_col(i, kk), -1.0)
                                 for i in cover[jx]], -np.inf, 0.0)

    # eq. 7: pxl_ovlp[j,k] <= pxl_g[j,k], <= pxl_g[j,k-1]; ovlp[j,0] == 0
    for jx in range(j_count):
        for kk in range(k):
            ocol = model.o_col(jx, kk)
            if kk == 0:
                add([(ocol, 1.0)], 0.0, 0.0)
                continue
            add([(ocol, 1.0), (model.g_col(jx, kk), -1.0)], -np.inf, 0.0)
            add([(ocol, 1.0), (model.g_col(jx, kk - 1), -1.0)], -np.inf, 0.0)

    # eq. 9: sum_k (pxl_g - pxl_ovlp) <= nb_data_reload
    for jx in range(j_count):
        add([(model.g_col(jx, kk), 1.0) for kk in range(k)]
            + [(model.o_col(jx, kk), -1.0) for kk in range(k)],
            -np.inf, float(nb_data_reload))

    # eq. 12 (optional): element-unit on-chip capacity per step
    if size_mem is not None:
        ker_elems = spec.kernel_elements
        for kk in range(k):
            add([(model.g_col(jx, kk), float(spec.c_in))
                 for jx in range(j_count)]
                + [(model.pg_col(i, kk), float(spec.c_out))
                   for i in range(x_count)],
                -np.inf, float(size_mem - ker_elems))

    # objective: min sum (pxl_g - pxl_ovlp)
    for jx in range(j_count):
        for kk in range(k):
            model.c[model.g_col(jx, kk)] = 1.0
            model.c[model.o_col(jx, kk)] = -1.0

    model.a = sparse.csr_matrix(
        (vals, (rows, cols)), shape=(r, n_vars))
    model.lb = np.asarray(con_lb)
    model.ub = np.asarray(con_ub)
    return model


def n_var_literal(spec: ConvSpec, k: int) -> int:  # lint: public-api
    """Paper's variable-count formula (Sec 7.1):
    N_var = K * (3*(H_in*W_in) + H_out*W_out)."""
    return k * (3 * spec.num_pixels + spec.num_patches)


# --------------------------------------------------------------------- #
# S2 schedule-order MILP (tiny instances)
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class S2OrderModel:
    """Exact schedule ordering of U fixed (patch-group, kernel-group)
    cells as a max-overlap Hamiltonian-path MILP.

    The S2 load cost decomposes as ``constant - sum of consecutive-cell
    overlaps`` (``|A \\ B| = |A| - |A ∩ B|``; the constant is fixed once
    the partitions are), so the order that minimises duration maximises
    the summed overlap ``W[u,v]`` along the schedule path.  Variables:
    ``x[u,t]`` (cell u at slot t, binary) and ``w[u,v,t]`` (cells u,v at
    consecutive slots t,t+1; continuous — forced to the product of the
    x's by the three linking rows).  Quadratic in U: tiny instances only.
    """

    n: int
    c: np.ndarray
    a: sparse.csr_matrix
    lb: np.ndarray
    ub: np.ndarray
    integrality: np.ndarray
    n_x: int

    @property
    def num_vars(self) -> int:
        return len(self.c)

    def x_col(self, u: int, t: int) -> int:
        return u * self.n + t

    def extract_order(self, x: np.ndarray) -> list[int]:
        order = []
        for t in range(self.n):
            for u in range(self.n):
                if x[self.x_col(u, t)] > 0.5:
                    order.append(u)
                    break
        return order


def build_s2_order_ilp(w_overlap: np.ndarray) -> S2OrderModel:
    """Assemble the order MILP for an overlap matrix ``w_overlap``
    (symmetric; forbidden adjacencies carry large negative entries)."""
    n = len(w_overlap)
    n_x = n * n
    pairs = [(u, v) for u in range(n) for v in range(n) if u != v]
    w_col = {}
    for t in range(n - 1):
        for u, v in pairs:
            w_col[(u, v, t)] = n_x + len(w_col)
    n_vars = n_x + len(w_col)

    c = np.zeros(n_vars)
    for (u, v, t), col in w_col.items():
        c[col] = -float(w_overlap[u, v])     # maximise summed overlap

    rows, cols, vals = [], [], []
    con_lb, con_ub = [], []
    r = 0

    def add(entries, lo, hi):
        nonlocal r
        for c_, v_ in entries:
            rows.append(r)
            cols.append(c_)
            vals.append(v_)
        con_lb.append(lo)
        con_ub.append(hi)
        r += 1

    def x_col(u, t):
        return u * n + t

    for u in range(n):                        # each cell in one slot
        add([(x_col(u, t), 1.0) for t in range(n)], 1.0, 1.0)
    for t in range(n):                        # each slot holds one cell
        add([(x_col(u, t), 1.0) for u in range(n)], 1.0, 1.0)
    for (u, v, t), col in w_col.items():      # w = x[u,t] AND x[v,t+1]
        add([(col, 1.0), (x_col(u, t), -1.0)], -np.inf, 0.0)
        add([(col, 1.0), (x_col(v, t + 1), -1.0)], -np.inf, 0.0)
        add([(col, 1.0), (x_col(u, t), -1.0), (x_col(v, t + 1), -1.0)],
            -1.0, np.inf)

    integrality = np.zeros(n_vars)
    integrality[:n_x] = 1                     # w relaxes to [0, 1]
    return S2OrderModel(
        n=n, c=c,
        a=sparse.csr_matrix((vals, (rows, cols)), shape=(r, n_vars)),
        lb=np.asarray(con_lb), ub=np.asarray(con_ub),
        integrality=integrality, n_x=n_x)


def solve_s2_order(w_overlap: np.ndarray, time_limit: float = 2.0,
                   ) -> tuple[list[int] | None, str]:
    """Solve the order MILP with HiGHS; returns (order|None, status)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    model = build_s2_order_ilp(np.asarray(w_overlap, dtype=float))
    res = milp(
        c=model.c,
        constraints=LinearConstraint(model.a, model.lb, model.ub),
        integrality=model.integrality,
        bounds=Bounds(0, 1),
        options={"time_limit": time_limit, "presolve": True})
    if res.x is None:
        return None, "infeasible" if res.status == 2 else "timeout"
    return model.extract_order(np.round(res.x)), (
        "optimal" if res.status == 0 else "feasible")
