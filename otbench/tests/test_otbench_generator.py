"""The traffic generator: shapes, ranges and seeding of every mix."""

from __future__ import annotations

import numpy as np
import pytest

from otbench import generator, harness

MIXES = ["scan1764", "study64", "calls1"]
SEEDS = [0, 7, 2 ** 31 + 5, 3_000_000_000, 2 ** 40 + 1]


def _mix(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


CONFIG = harness.load_json(harness.HERE / "configs" / "farfield11.json")


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
        assert u["starts"].shape == (64, 3)
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
