"""The end-of-run check that no module of the process belongs to JAX or to
the JAX package, by whole top-level names."""

import subprocess
import sys

from benchmark.run import ROOT, jax_loaded


def test_names_compare_whole():
    assert jax_loaded(["dnsjax_torch.ops", "dnsjax_torch", "jaxtyping", "benchmark.run"]) == []
    assert jax_loaded(["dnsjax.ops"]) == ["dnsjax"]
    assert jax_loaded(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax",
                                                                            "jaxlib"]


def test_harness_and_port_load_no_jax():
    """Importing the harness, its reference, its readers and the port's
    driver in a fresh process loads none of them."""
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.run as r, benchmark.follow, "
            "benchmark.trace, benchmark.counts, benchmark.sequence; "
            "import dnsjax_torch.slam.driver; "
            "[r.load_reader(m['name']) for m in r.load_cell('replica-slam')[3]['per_layer']]; "
            "print(r.jax_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
