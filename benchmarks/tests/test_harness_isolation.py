"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program either.  Each check imports in a
fresh process and compares the top-level name of every loaded module, as a
whole word: `stabnet_tpu_torch` begins with `stabnet_tpu` and is allowed."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
DRIVERS = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "drivers"))
                 if f.endswith(".py") and f != "__init__.py")
REFERENCE = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "reference"))
                   if f.endswith(".py") and f != "__init__.py")


def loaded_after(imports):
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_is_a_whole_word():
    from benchmarks.harness.isolation import forbidden_modules

    assert forbidden_modules(["stabnet_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["stabnet_tpu.ops", "jax.numpy", "flax"]) == [
        "flax", "jax", "stabnet_tpu"]


@pytest.mark.parametrize("module", ["benchmarks.harness.main", "benchmarks.limits"]
                         + [f"benchmarks.drivers.{d}" for d in DRIVERS])
def test_harness_and_drivers(module):
    mods = loaded_after([module])
    assert not mods & {"jax", "jaxlib", "flax", "orbax", "stabnet_tpu"}, mods


def test_drivers_with_the_program():
    mods = loaded_after([f"benchmarks.drivers.{d}" for d in DRIVERS]
                        + ["stabnet_tpu_torch.stream.driver", "stabnet_tpu_torch.eval.metrics"])
    assert not mods & {"jax", "jaxlib", "flax", "orbax", "stabnet_tpu"}, mods


@pytest.mark.parametrize("module", REFERENCE)
def test_reference_is_plain(module):
    mods = loaded_after([f"benchmarks.reference.{module}"])
    assert not mods & {"jax", "jaxlib", "flax", "orbax", "stabnet_tpu", "stabnet_tpu_torch"}, mods
