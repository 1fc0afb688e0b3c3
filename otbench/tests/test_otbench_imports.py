"""What the benchmark imports, in fresh interpreters: nothing of JAX or the
JAX package anywhere, nothing of the port in the reference; and the run
refuses to run, printing no result, without a card. The card-only case
runs one short cell on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "waveform_ot_tpu")


def _modules_after(code: str) -> set[str]:
    """Top-level names of the modules loaded after ``code`` runs in a fresh
    interpreter at the repository root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    metrics = sorted(p.stem for p in (ROOT / "otbench" / "metrics").glob("*.py"))
    mods = sorted(p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
                  for p in (ROOT / "otbench").rglob("*.py")
                  if "tests" not in p.parts and "metrics" not in p.parts)
    code = "\n".join([f"import {m}" for m in mods]
                     + ["from otbench import harness"]
                     + [f"harness.reader({m!r})" for m in metrics])
    loaded = _modules_after(code)
    assert "otbench" in loaded and "waveform_ot_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    loaded = _modules_after("import otbench.reference, otbench.reference.misfit, "
                            "otbench.reference.farfield, otbench.reference.layered")
    assert "torch" in loaded
    assert not loaded & {"waveform_ot_torch", *FORBIDDEN}


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "otbench.run", "--workload", "layered.calls",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "otbench.run", "--workload", "farfield.scan",
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"models_per_s", "scan_peak_gib", "setup_s"}
