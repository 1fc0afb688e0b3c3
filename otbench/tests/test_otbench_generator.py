"""The traffic generator: shapes, ranges and seeding of every mix."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from conftest import MSCAL

from otbench import generator, harness

MIXES = ["scan1764", "study64", "study64host", "calls1"]
SEEDS = [0, 7, 2 ** 31 + 5, 3_000_000_000, 2 ** 40 + 1]


def _mix(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


CONFIG = harness.load_json(harness.HERE / "configs" / "farfield11.json")
JOINT = {**CONFIG, "invert": "loc_cmt"}

# sha256 of units 0 and 1 and the warm-up unit of each location-only mix,
# drawn by the generator before it knew moment tensors and solvers: a
# configuration without ``invert`` draws the same units bit for bit
PARENT_UNITS = {
    ("scan1764", 2 ** 31 + 5): "2b92a03cb50c592dd0eb6d1b9ca43d73f167ef9ac6e330760fa31e6724e6e733",
    ("scan1764", 3_000_000_017): "f0578798bfa2f956b7b6edde3748c695e473499df7894570332fecdd5bd01015",
    ("study64", 2 ** 31 + 5): "2e023dc456b104294624562658c0f9104ed2fa695ee2ba6441ccaa8252e64a5c",
    ("study64", 3_000_000_017): "fa7f10910b72add410d1f97fe79092396829bf83fea420ae804de05983eb91b5",
    ("calls1", 2 ** 31 + 5): "1ca5bc469abd46e8cb68ba68f7b0d277da79298edc4bd30f0c39ac5eb5ebf2eb",
    ("calls1", 3_000_000_017): "a6ba9078ccbcb4885a46a1db76565e839ea9b123f70cf378d423be024c4a5acb",
}


def _units_sha(mix, config, seed):
    h = hashlib.sha256()
    for index, stream in ((0, generator.WINDOW), (1, generator.WINDOW), (0, generator.WARM)):
        u = generator.unit(_mix(mix), config, seed, index, stream)
        for k in sorted(u):
            h.update(k.encode())
            h.update(np.ascontiguousarray(u[k], np.float64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_unit_shapes_and_ranges(mix, seed):
    t = _mix(mix)
    loc = np.asarray(CONFIG["source_km"])
    u = generator.unit(t, CONFIG, seed, 3)
    if t["kind"] == "scan":
        n = generator.models_per_unit(t)
        assert n == 1764 and u["nodes"].shape == (1764, 3)
        assert u["x"].shape == (21,) and u["y"].shape == (21,) and u["z"].shape == (4,)
        # meshgrid(z, x, y, indexing="ij"): z slowest, y fastest
        np.testing.assert_array_equal(u["nodes"][:21, 1], u["y"])
        np.testing.assert_array_equal(u["nodes"][::21, 0][:21], u["x"])
        np.testing.assert_array_equal(u["nodes"][::441, 2], u["z"])
        centre = np.array([u["x"].mean(), u["y"].mean()])
        assert np.all(np.abs(centre - loc[:2]) <= t["centre_jitter_km"])
        np.testing.assert_allclose(np.diff(u["x"]), 2.0)
    elif t["kind"] == "study":
        assert u["starts"].shape == (64, 3) and generator.solver(t) in generator.SOLVERS
        assert np.all(np.abs(u["starts"] - loc) <= t["start_spread_km"])
    else:
        assert u["m"].shape == (3,) and generator.models_per_unit(t) == 1
        assert np.all(np.abs(u["m"] - loc) <= t["spread_km"])


@pytest.mark.parametrize("mix", MIXES)
def test_seeding(mix):
    t = _mix(mix)
    key = {"scan": "nodes", "study": "starts", "calls": "m"}[t["kind"]]
    a = generator.unit(t, CONFIG, 2 ** 31 + 5, 0)[key]
    np.testing.assert_array_equal(a, generator.unit(t, CONFIG, 2 ** 31 + 5, 0)[key])
    assert not np.array_equal(a, generator.unit(t, CONFIG, 2 ** 31 + 5, 1)[key])
    assert not np.array_equal(a, generator.unit(t, CONFIG, 2 ** 31 + 6, 0)[key])
    assert not np.array_equal(a, generator.unit(t, CONFIG, 2 ** 31 + 5, 0,
                                                stream=generator.WARM)[key])


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        generator.unit({"kind": "nope"}, CONFIG, 1, 0)
    with pytest.raises(ValueError):
        generator.models_per_unit(_mix("study64"))


@pytest.mark.parametrize("mix,seed", sorted(PARENT_UNITS), ids=[f"{m}-{s}" for m, s in
                                                               sorted(PARENT_UNITS)])
@pytest.mark.parametrize("config", ["farfield11", "fukuoka11"])
def test_location_units_are_the_parents(mix, seed, config):
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    assert _units_sha(mix, cfg, seed) == PARENT_UNITS[(mix, seed)]


def test_host_study_starts_are_the_device_studys():
    """The host-solver mix draws the same starts as the device one: only the
    solver differs between the two study cells."""
    for seed, i in ((2 ** 31 + 5, 0), (3_000_000_017, 4)):
        np.testing.assert_array_equal(generator.unit(_mix("study64host"), CONFIG, seed, i)["starts"],
                                      generator.unit(_mix("study64"), CONFIG, seed, i)["starts"])


@pytest.mark.parametrize("mix,key", [("study64", "starts"), ("calls1", "m")])
@pytest.mark.parametrize("mscal", [None, MSCAL])
def test_joint_units(mix, key, mscal):
    """A joint configuration's models: the location-only draw first, then
    each upper component of the true moment tensor times 1 + uniform(+-mt_spread),
    from the same stream, all divided by mscal where it is given."""
    t = {**_mix(mix), "mt_spread": 0.3}
    seed = 3_000_000_017
    loc = generator.unit(t, CONFIG, seed, 2)[key].reshape(-1, 3)
    m = generator.unit(t, {**JOINT, "mscal": mscal}, seed, 2)[key].reshape(-1, 9)
    if mscal is not None:
        m = m * np.asarray(mscal)
    np.testing.assert_allclose(m[:, :3], loc, rtol=1e-15)
    true = generator.true_moment_upper(CONFIG)
    ratio = m[:, 3:] / true
    assert np.all(np.abs(ratio - 1.0) <= 0.3 + 1e-12) and np.ptp(ratio) > 0.1
    np.testing.assert_allclose(true, [-3417115.9741, 2856756.3040, -647047.6128, 355253.7956,
                                      -2414814.5657, 3061862.1785], rtol=1e-10)
    assert generator.n_params(JOINT) == 9 and generator.n_params(CONFIG) == 3


def test_joint_scan_bad_invert_and_bad_solver_raise():
    with pytest.raises(ValueError, match="location only"):
        generator.unit(_mix("scan1764"), JOINT, 1, 0)
    with pytest.raises(ValueError, match="invert"):
        generator.unit(_mix("calls1"), {**CONFIG, "invert": "cmt"}, 1, 0)
    with pytest.raises(ValueError, match="solver"):
        generator.solver({**_mix("study64"), "solver": "gpu"})
