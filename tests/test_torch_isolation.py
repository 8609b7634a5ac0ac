"""The port stands alone: in a fresh interpreter where importing ``jax``
fails, every ``repro_torch`` module and ``chip_smoke`` import, and no
``jax*`` or ``repro``/``repro.*`` module gets loaded."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    sys.modules["jax"] = None            # any `import jax` now raises
    sys.path.insert(0, os.path.join({root!r}, "src"))
    sys.path.insert(0, {root!r})
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro")
                 and sys.modules[m] is not None)
    print(len(names), bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 25 and bad.strip() == "[]"


def test_port_sources_have_no_jax_or_reference_imports():
    roots = [os.path.join(ROOT, "src", "repro_torch"),
             os.path.join(ROOT, "chip_smoke.py")]
    files = [roots[1]] + [os.path.join(d, f)
                          for d, _, fs in os.walk(roots[0]) for f in fs
                          if f.endswith(".py")]
    for path in files:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro\n", "from repro.",
                                     "from repro import")), (path, s)
            assert not (s.startswith("import repro") and
                        not s.startswith("import repro_torch")), (path, s)
