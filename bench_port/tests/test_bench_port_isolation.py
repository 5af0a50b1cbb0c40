"""Without a card the measurement path exits with code 2 and prints no
result; nothing the harness, the check, the checks or the entries import
loads `jax`, `jaxlib`, `flax` or `video_segment_tpu` (top-level names
compared whole), and the check's reference (`compare.py`, `generator.py`,
`checks/`) imports nothing of the port, nor cv2."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BANNED = ("jax", "jaxlib", "flax", "video_segment_tpu")


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "c2_272x480.long140", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_imports_load_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import bench_port.harness, bench_port.control, bench_port.compare\n"

        "for pkg in ('bench_port.entries', 'bench_port.metrics',\n"
        "            'bench_port.checks'):\n"
        "    p = importlib.import_module(pkg)\n"
        "    for m in pkgutil.iter_modules(p.__path__):\n"
        "        importlib.import_module(pkg + '.' + m.name)\n"
        "import video_segment_tpu_torch.api\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r})\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["compare.py", "generator.py",
                                  "proto_schema.py"] + sorted(
    os.path.relpath(p, os.path.join(ROOT, "bench_port")) for p in
    glob.glob(os.path.join(ROOT, "bench_port", "checks", "*.py"))))
def test_reference_imports_nothing_of_the_port(name):
    with open(os.path.join(ROOT, "bench_port", name)) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in BANNED + (
                "video_segment_tpu_torch", "cv2"), (name, n)
