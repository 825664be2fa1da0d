"""Kernel B3's folded compare, mirrored on the CPU.

The kernel (csrc/neighbor_counts.cu) counts a pair where u = fl(|q|² −
2·q·x) satisfies u <= T_x, in place of fl(u + |x|²) <= eps2.  T_x is the
largest f32 u for which the second holds, found once per point by
bisection over the f32 bit patterns in the order of their values.  This
file repeats that bisection in torch, step for step, and holds it against
the direct form on u values around each threshold and across a wide
range: no n² work, a few thousand values.
"""

import numpy as np
import torch

INF = float("inf")
TWO31 = 2**31


def order_keys(f: torch.Tensor) -> torch.Tensor:
    """f32 values → int64 keys in the order of the values (the kernel's
    ``order_key``: sign bit set for positives, all bits flipped for
    negatives, read as unsigned)."""
    b = f.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b + TWO31, -1 - b)


def key_values(k: torch.Tensor) -> torch.Tensor:
    b = torch.where(k >= TWO31, k - TWO31, -1 - k)
    return b.to(torch.int32).view(torch.float32)


def count_thresholds(xx: torch.Tensor, eps2: torch.Tensor) -> torch.Tensor:
    """The kernel's ``count_threshold``: 32 halvings between -inf and +inf."""
    lo = order_keys(torch.full_like(xx, -INF))
    hi = order_keys(torch.full_like(xx, INF))
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        ok = (key_values(mid) + xx) <= eps2
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return key_values(lo)


def test_order_keys_follow_the_values():
    f = torch.tensor([-INF, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1e-38, 1.0, 3e38, INF])
    k = order_keys(f)
    assert bool((k[1:] > k[:-1]).all())
    assert torch.equal(key_values(k).view(torch.int32), f.view(torch.int32))


# squared norms from 0 and subnormals to just below the kernel's 2^126
# limit, and eps² from 0 through the geo grid's to large; (1e6, 1e6 + 1 ulp)
# puts T_x millions of u-ulps away from fl(eps² − |x|²)
XX = [0.0, 1e-45, 1e-30, 0.0025, 0.09, 1.0, 1e6, 3.0e7, 1e20, 8.0e37]
EPS2 = [0.0, 1e-45, 1e-12, 0.0025, 0.09, 0.25, 1.0, float(np.nextafter(np.float32(1e6), np.float32(2e6))),
        3e37, -1.0]


def test_threshold_matches_direct_compare():
    """For every (|x|², eps²): u <= T_x exactly where fl(u + |x|²) <= eps²,
    on the 81 f32 values within 40 ulps of T_x and 60 values spread from
    −1e38 to 1e38; T_x itself counts and the next f32 above does not."""
    g = np.random.default_rng(0)
    xx_all, e_all, u_all, t_all = [], [], [], []
    for xx in XX:
        for e in EPS2:
            x32 = torch.tensor([xx], dtype=torch.float32)
            e32 = torch.tensor([e], dtype=torch.float32)
            t = count_thresholds(x32, e32)
            near = key_values(order_keys(t) + torch.arange(-40, 41))
            wide = torch.from_numpy((g.standard_normal(60) * 10.0 ** g.integers(-30, 38, 60))
                                    .astype(np.float32))
            u = torch.cat([near, wide])
            u_all.append(u)
            t_all.append(t.expand_as(u))
            xx_all.append(x32.expand_as(u))
            e_all.append(e32.expand_as(u))
    u, t, xx, e = (torch.cat(v) for v in (u_all, t_all, xx_all, e_all))
    assert len(u) == len(XX) * len(EPS2) * 141
    direct = (u + xx) <= e
    assert torch.equal(u <= t, direct)
    # the threshold is the largest such u
    assert bool(((t + xx) <= e).all())
    above = key_values(order_keys(t) + 1)
    assert not bool(((above + xx) <= e).any())
