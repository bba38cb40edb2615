"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared as whole
top-level words: trino_tpu_torch begins with trino_tpu."""
import os
import subprocess
import sys

import pytest

from portbench.core import guard

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_compare_as_whole_words():
    assert guard.top("trino_tpu_torch.ops.kernels") == "trino_tpu_torch"
    assert guard.top("trino_tpu_torch") not in guard.FORBIDDEN
    assert guard.top("trino_tpu.session") in guard.FORBIDDEN
    assert guard.top("jaxtyping") not in guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(PKG)), ids=lambda p: os.path.relpath(p, PKG))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = guard.imports_of(path) & (guard.FORBIDDEN | {"chip_smoke"})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(PKG, "reference"))),
                         ids=lambda p: os.path.basename(p))
def test_the_reference_imports_nothing_of_the_program(path):
    names = guard.imports_of(path)
    assert guard.PORT not in names and not names & guard.FORBIDDEN, names
    assert names <= {"__future__", "datetime", "decimal", "fractions", "typing",
                     "torch", "numpy", "portbench"}, names


def test_the_guard_sees_what_imports_miss(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import importlib\nimportlib.import_module('trino_tpu.session')\n"
                   "from trino_tpu_torch import session\n")
    assert guard.imports_of(str(mod)) == {"importlib", "trino_tpu", "trino_tpu_torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Import every module a run imports, the program's included, in a
    fresh process, and list what sys.modules holds."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.core import check, loop, qgen, roofline, spec, stats, trace\n"
            "import trino_tpu_torch.session, trino_tpu_torch.testing.runner\n"
            "import trino_tpu_torch.client.client, trino_tpu_torch.ops.kernels\n"
            "from portbench.core import guard\n"
            "print(sorted(guard.loaded()))\n") % ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
