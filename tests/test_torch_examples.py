"""A7's examples on the port, small on the CPU.

  * ``quickstart`` writes its embedding into the working directory and
    reports three qualities;
  * ``interactive_hparams``: from one JAX-made state carried across by
    ``convert``, a few steps of each of the five phases through the port's
    ``make_step`` and through the JAX ``make_step`` give the same DBSCAN
    cluster count after every phase (each package counts with its own
    example's ``cluster_count``), and the kernel library is built no time
    after the first phase;
  * ``hierarchy_graph``'s cluster counts per level equal
    ``repro.core.hierarchy.extract_hierarchy``'s at the same small size;
  * each ``main`` takes ``--device cpu`` and runs on ``cuda`` by default
    (which raises here, where there is none).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import hierarchy as jh  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.data.synthetic import hierarchical_cells, mnist_like  # noqa: E402
from repro_torch.examples import (hierarchy_graph, interactive_hparams,  # noqa: E402
                                  quickstart)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _reference_example(name):
    """The JAX package's example script as a module (its ``main`` is not
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(st):
    out = {k: np.asarray(v) for k, v in st._asdict().items() if k != "rng"}
    out["rng"] = np.asarray(jax.random.key_data(st.rng))
    return out


def test_quickstart_small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lines = []
    q = quickstart.run(n=320, dim=16, n_iter=60, log=lines.append,
                       device="cpu")
    assert set(q) == {"hd_knn", "embedding", "one_nn"}
    assert all(0.0 <= v <= 1.0 for v in q.values())
    assert q["hd_knn"] > 0.5 and q["one_nn"] > 0.5
    Y = np.load(tmp_path / quickstart.OUT)
    assert Y.shape == (320, 2) and np.isfinite(Y).all()
    assert lines[-1] == f"wrote {quickstart.OUT}" and len(lines) == 4


def test_interactive_hparams_cluster_counts_match_jax():
    ref = _reference_example("interactive_hparams")
    n, dim, iters = 300, 16, (4, 4, 4, 4, 4)
    X, _ = mnist_like(n=n, dim=dim, seed=0)
    jcfg = jf.FuncSNEConfig(n_points=n, dim_hd=dim, backend="xla")
    jst = jf.init_state(jax.random.PRNGKey(0), jnp.asarray(X), jcfg)
    tcfg = tf.FuncSNEConfig(n_points=n, dim_hd=dim)
    tst = convert.state_from_numpy(_fields(jst), tcfg, "cpu")

    # the reference example's phases, on its own hparams
    hp = jf.default_hparams(n, perplexity=15.0)
    jphases = [
        (iters[0], hp._replace(exaggeration=jnp.float32(12.0),
                               momentum=jnp.float32(0.5))),
        (iters[1], hp),
        (iters[2], hp._replace(alpha=jnp.float32(0.5), lr=hp.lr * 0.3)),
        (iters[3], hp._replace(alpha=jnp.float32(0.5),
                               repulsion=jnp.float32(3.0), lr=hp.lr * 0.3)),
        (iters[4], hp._replace(perplexity=jnp.float32(40.0),
                               lr=hp.lr * 0.3)),
    ]
    jstep = jf.make_step(jcfg)
    want = []
    for steps, ph in jphases:
        for _ in range(steps):
            jst = jstep(jst, jnp.asarray(X), ph)
        want.append(ref.cluster_count(np.asarray(jst.Y)))

    thp = tf.default_hparams(n, perplexity=15.0, device="cpu")
    plan = interactive_hparams.phases(thp, iters)
    assert [p[0] for p in plan][4].startswith("perplexity 15 -> 40")
    lines = []
    st, report, builds = interactive_hparams.run_phases(
        tst, torch.from_numpy(X), tcfg, plan, log=lines.append)
    assert [r["clusters"] for r in report] == want
    assert builds == 0 and lines[-1].endswith("after the first phase: 0")
    assert all(r["iters"] == 4 and r["it_s"] > 0 for r in report)
    assert bool(torch.isfinite(st.Y).all())
    assert len(set(want)) > 1          # the phases change the clustering


def test_hierarchy_graph_counts_match_jax():
    """The example at 240 cells and 10 steps a level (40 steps in all):
    the packages' Y stay within 1.3e-6 of each other and every level's
    clusters, sizes and strong edges agree.  Over longer runs the two
    part at a near-tie, as ROADMAP's observations on exact LD lists say:
    at 15 steps a level, step 14 swaps two slots of row 18's LD list
    whose distances are 4e-5 apart (20.50334 / 20.50338), and the third
    level then counts 12 clusters against 10."""
    kw = dict(alphas=(3.0, 1.0, 0.5), iters_per_level=10, warmup_iters=10)
    graph, counts, strong = hierarchy_graph.run(
        n=240, dim=12, log=lambda _: None, device="cpu", **kw)
    X, _, _ = hierarchical_cells(n=240, dim=12, n_major=4,
                                 minors_per_major=4, seed=0)
    want = jh.extract_hierarchy(X, **kw)
    assert counts == [lv.n_clusters for lv in want.levels]
    assert [lv.sizes for lv in graph.levels] == \
        [lv.sizes for lv in want.levels]
    assert strong == [e for e in want.edges if e[4] > 0.5]
    assert max(counts) > 1


@pytest.mark.parametrize("mod", [quickstart, interactive_hparams,
                                 hierarchy_graph])
def test_entry_points(monkeypatch, mod):
    """``main`` passes ``--device`` to ``run`` and defaults to cuda, which
    raises where CUDA is missing."""
    seen = []
    monkeypatch.setattr(mod, "run", lambda device: seen.append(device))
    mod.main(["--device", "cpu"])
    mod.main([])
    assert seen == ["cpu", "cuda"]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(device="cuda")
