"""The plain reference against hand-computed energies and forces, and its
pair search against brute force."""

import itertools
import math

import pytest
import torch

from ljbench.reference import lj

BOX = 10.0
RC = 2.5
VOL = BOX ** 3


def pair_u(r):
    return 4.0 * (r ** -12 - r ** -6)


def pair_force(r):  # -dU/dr
    return 24.0 * (2.0 * r ** -12 - r ** -6) / r


def pair_du(r):  # r dU/dr
    return 24.0 * (r ** -6 - 2.0 * r ** -12)


def pair_ddu(r):  # r^2 d2U/dr2
    return 24.0 * (26.0 * r ** -12 - 7.0 * r ** -6)


def state(*xyz):
    return torch.tensor([list(xyz)], dtype=torch.float64)


def test_two_particles():
    r = 1.2
    pos = state([1.0, 1.0, 1.0], [1.0 + r, 1.0, 1.0])
    acc, u, du, ddu = lj.forces(pos, lj.pair_list(pos, BOX, RC), BOX, RC, VOL, tail=False)
    assert float(u[0]) == pytest.approx(pair_u(r), rel=1e-14)
    assert float(du[0]) == pytest.approx(pair_du(r), rel=1e-14)
    assert float(ddu[0]) == pytest.approx(pair_ddu(r), rel=1e-14)
    f = pair_force(r)  # < 0 past 2^(1/6): attractive, pulls 0 to +x and 1 to -x
    assert acc[0].flatten().tolist() == pytest.approx([-f, 0.0, 0.0, f, 0.0, 0.0], rel=1e-14)


def test_two_particles_through_the_boundary_and_past_the_cutoff():
    pos = state([0.3, 5.0, 5.0], [9.6, 5.0, 5.0])  # 0.7 apart by the minimum image
    acc, u, _, _ = lj.forces(pos, lj.pair_list(pos, BOX, RC), BOX, RC, VOL, tail=False)
    assert float(u[0]) == pytest.approx(pair_u(0.7), rel=1e-13)
    f = pair_force(0.7)
    assert acc[0, 0, 0].item() == pytest.approx(f, rel=1e-13)  # pushed to +x, away from 9.6
    far = state([1.0, 1.0, 1.0], [1.0, 1.0, 1.0 + RC + 1e-9])
    acc, u, _, _ = lj.forces(far, lj.pair_list(far, BOX, RC + 1.0), BOX, RC, VOL, tail=False)
    assert float(u[0]) == 0.0 and float(acc.abs().max()) == 0.0


def test_three_particles():
    pts = [[1.0, 1.0, 1.0], [2.1, 1.0, 1.0], [1.0, 2.3, 1.4]]
    pos = state(*pts)
    acc, u, du, ddu = lj.forces(pos, lj.pair_list(pos, BOX, RC), BOX, RC, VOL, tail=False)
    want_a = [[0.0] * 3 for _ in pts]
    want_u = want_du = want_ddu = 0.0
    for i, j in itertools.combinations(range(3), 2):
        d = [pts[i][k] - pts[j][k] for k in range(3)]
        r = math.sqrt(sum(x * x for x in d))
        want_u += pair_u(r)
        want_du += pair_du(r)
        want_ddu += pair_ddu(r)
        for k in range(3):
            want_a[i][k] += pair_force(r) * d[k] / r
            want_a[j][k] -= pair_force(r) * d[k] / r
    assert float(u[0]) == pytest.approx(want_u, rel=1e-13)
    assert float(du[0]) == pytest.approx(want_du, rel=1e-13)
    assert float(ddu[0]) == pytest.approx(want_ddu, rel=1e-13)
    assert acc[0].flatten().tolist() == pytest.approx(sum(want_a, []), rel=1e-12, abs=1e-12)


def test_tail_terms_against_the_reference_programs_closed_form():
    n = 500
    tf = 8.0 * math.pi * n * n / (VOL * RC ** 3)
    want = (tf * (1.0 / (3.0 * RC ** 6) - 1.0) / 3.0, 2.0 * tf * (-2.0 / (3.0 * RC ** 6) + 1.0),
            2.0 * tf * (26.0 / (3.0 * RC ** 6) - 7.0))
    assert lj.tail_terms(n, VOL, RC) == pytest.approx(want, rel=1e-14)


def test_observables_of_a_state():
    pos = state([1.0, 1.0, 1.0], [2.2, 1.0, 1.0])
    vel = torch.tensor([[[0.5, 0.0, 0.0], [0.0, -1.0, 2.0]]], dtype=torch.float64)
    _, obs, d_abs = lj.state_observables(pos, vel, BOX, RC, VOL, tail=False)
    k = 0.5 * (0.25 + 1.0 + 4.0)
    t = 2.0 * k / 6.0
    want = [pair_u(1.2), k, pair_u(1.2) + k, t, (2 / VOL) * t - pair_du(1.2) / (3 * VOL)]
    assert obs[0].tolist() == pytest.approx(want, rel=1e-13)
    assert float(d_abs[0]) == pytest.approx(abs(pair_du(1.2)), rel=1e-13)


def brute_pairs(x, box, radius):
    out = set()
    for i, j in itertools.combinations(range(x.shape[0]), 2):
        d = x[i] - x[j]
        d = d - box * torch.round(d / box)
        if float((d * d).sum()) < radius * radius:
            out.add((i, j))
    return out


def test_pair_search_against_brute_force(monkeypatch):
    monkeypatch.setattr(lj, "BLOCK_ELEMENTS", 1000)  # several row blocks
    g = torch.Generator().manual_seed(11)
    box, n = 6.0, 90
    pos = torch.rand((2, n, 3), generator=g, dtype=torch.float64) * box
    i, j = lj.pair_list(pos, box, 2.2)
    got = {(int(a), int(b)) for a, b in zip(i, j)}
    want = brute_pairs(pos[0], box, 2.2) | {(a + n, b + n) for a, b in brute_pairs(pos[1], box, 2.2)}
    assert got == want
    counts = lj.count_pairs(pos, box, 1.7)
    assert counts.tolist() == [len(brute_pairs(pos[q], box, 1.7)) for q in range(2)]


def test_advance_one_step_by_hand_and_energy_conservation():
    pos = state([1.0, 1.0, 1.0], [2.2, 1.0, 1.0])
    vel = torch.tensor([[[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0]]], dtype=torch.float64)
    dt = 0.001
    r1, v1, a1 = lj.advance(pos, vel, 1, BOX, RC, dt, VOL, tail=False)
    a0 = pair_force(1.2)
    x0 = 1.0 + 0.1 * dt - 0.5 * a0 * dt * dt
    x1 = 2.2 - 0.1 * dt + 0.5 * a0 * dt * dt
    assert r1[0, :, 0].tolist() == pytest.approx([x0, x1], rel=1e-14)
    a_new = pair_force(x1 - x0)
    assert v1[0, 0, 0].item() == pytest.approx(0.1 - 0.5 * dt * (a0 + a_new), rel=1e-12)


def test_advance_rebuilds_keep_every_pair_and_conserve_energy():
    g = torch.Generator().manual_seed(5)
    lat = torch.stack(torch.meshgrid(*[torch.arange(4, dtype=torch.float64)] * 3, indexing="ij"),
                      -1).reshape(1, 64, 3) * 1.5 + 0.2
    v0 = torch.rand((1, 64, 3), generator=g, dtype=torch.float64) - 0.5
    # A list of radius 5.5 holds every minimum-image pair of a box of 6 and is never rebuilt.
    thin = lj.advance(lat, v0, 200, 6.0, RC, 0.002, 216.0, skin=0.3, tail=False)
    whole = lj.advance(lat, v0, 200, 6.0, RC, 0.002, 216.0, skin=3.0, tail=False)
    for a, b in zip(thin, whole):
        assert torch.allclose(a, b, rtol=0.0, atol=1e-12)
    three = state([1.0, 1.0, 1.0], [2.15, 1.0, 1.0], [1.5, 2.0, 1.2])
    vel = torch.tensor([[[0.3, 0.0, 0.1], [-0.2, 0.1, 0.0], [0.0, -0.2, 0.1]]], dtype=torch.float64)

    def energy(r, v):
        return float(lj.state_observables(r, v, BOX, RC, VOL, tail=False)[1][0, 2])

    r1, v1, _ = lj.advance(three, vel, 500, BOX, RC, 0.001, VOL, tail=False)
    assert abs(energy(r1, v1) - energy(three, vel)) < 1e-6 * abs(energy(three, vel))
