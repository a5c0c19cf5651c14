"""What the harness and the reference load, in fresh processes: nothing of
jax or the JAX package (whole top-level names), and the reference nothing
of the system under test."""

import json
import subprocess
import sys

from slam_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "my_orb_slam2_tpu"}


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_system():
    tops = _tops("import slam_bench.reference.frontend, slam_bench.reference.pose_opt, "
                 "slam_bench.reference.local_ba, slam_bench.reference.global_ba, slam_bench.checks, "
                 "slam_bench.gba_problem, slam_bench.world, slam_bench.yardstick")
    assert not tops & (FORBIDDEN | {"my_orb_slam2_tpu_torch"}), tops


def test_harness_loads_no_jax():
    names = [m["name"] for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]]
    tops = _tops("import slam_bench.run, slam_bench.drivers.stream, slam_bench.drivers.gba, slam_bench.trace\n"
                 "import my_orb_slam2_tpu_torch.models.system, my_orb_slam2_tpu_torch.ops.ba\n"
                 "from slam_bench import spec\n"
                 f"[spec.reader(n) for n in {names!r}]")
    assert "my_orb_slam2_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
