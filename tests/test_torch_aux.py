# -*- coding: utf-8 -*-
"""The port's utilities: ``profiling`` (timeit, annotate, trace), the
kernel reference generated from the DSL specs (``dsl/docgen.py``), held to
the JAX package's text, and the single-chain step-size probe the samplers'
pooling layer brought with it.  At most four test functions."""

import glob
import os

import numpy as np
import torch

torch.set_num_threads(1)


def test_timeit_annotate_and_trace(tmp_path):
    """``timeit`` is the best of its timed calls, passes ``vary``'s
    arguments (warmup calls get -1, -2, ...), and reaches every tensor of
    nested outputs; ``trace`` writes a trace file that holds the
    ``annotate`` span."""
    from george_tpu_torch import profiling

    seen = []

    def fn(a, scale=1.0, i=None):
        seen.append(i)
        return {"out": (a * scale, [a + 1.0])}

    a = torch.ones(8, dtype=torch.float64)
    best = profiling.timeit(fn, a, repeats=3, warmup=2,
                            vary=lambda i: {"i": i}, scale=2.0)
    assert seen == [-1, -2, 0, 1, 2]
    assert 0.0 <= best < 1.0
    assert len(list(profiling._leaves(fn(a, i=0)))) == 2

    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("george_tpu_torch.test_span"):
            torch.linalg.cholesky(torch.eye(16, dtype=torch.float64) * 2.0)
    names = {e.key for e in prof.key_averages()}
    assert "george_tpu_torch.test_span" in names
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        assert "george_tpu_torch.test_span" in f.read()


def _as_port(text):
    """The JAX package's reference text with its package read as the
    port's (paths and commands) and its drift test as the port's."""
    return text.replace("george_tpu", "george_tpu_torch").replace(
        "tests/test_docs.py", "tests/test_torch_aux.py")


def test_kernel_reference_matches_the_jax_package_and_is_current():
    from george_tpu.dsl import docgen as jdocgen
    from george_tpu_torch.dsl import docgen

    text = docgen.render_kernel_docs()
    assert text == _as_port(jdocgen.render_kernel_docs())
    assert docgen.DEFAULT_PATH.endswith(
        os.path.join("docs", "kernels_reference_torch.md"))
    assert os.path.exists(docgen.DEFAULT_PATH), (
        "docs/kernels_reference_torch.md is missing; run "
        "`python -m george_tpu_torch.dsl.docgen`")
    with open(docgen.DEFAULT_PATH) as f:
        assert f.read() == text, (
            "docs/kernels_reference_torch.md is stale; regenerate with "
            "`python -m george_tpu_torch.dsl.docgen`")
    from george_tpu_torch.dsl.specs import load_specs

    for name in load_specs():
        assert "## `{0}`".format(name) in text


def test_docgen_main_writes_the_reference(tmp_path):
    from george_tpu_torch.dsl import docgen

    path = str(tmp_path / "kernels.md")
    docgen.main(path)
    with open(path) as f:
        assert f.read() == docgen.render_kernel_docs()


def test_find_reasonable_step_size_single_chain(monkeypatch):
    """The single-chain step-size probe against the JAX package's on the
    same momentum (the port's draw replaced by the JAX key's through a
    runtime patch): from 1.0 up and from 100.0 down, the same step."""
    import jax
    import jax.numpy as jnp
    from george_tpu.samplers import adaptation as jadapt
    from george_tpu.samplers import hmc as jhmc
    from george_tpu_torch.samplers import adaptation as tadapt
    from george_tpu_torch.samplers.hmc import HMCState

    prec = torch.tensor([[2.0, 0.3, 0.0], [0.3, 1.0, 0.1], [0.0, 0.1, 4.0]],
                        dtype=torch.float64)

    def batched_vg(z):
        return -0.5 * torch.sum((z @ prec) * z, dim=-1), -(z @ prec)

    z = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    logp, grad = (a[0] for a in batched_vg(z[None]))
    inv_mass = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
    jvg = jax.value_and_grad(
        lambda q: -0.5 * q @ jnp.asarray(prec.numpy()) @ q)
    jstate = jhmc.HMCState(jnp.asarray(z.numpy()), *jvg(jnp.asarray(
        z.numpy())))
    for seed, eps0 in ((0, 1.0), (1, 100.0)):
        key = jax.random.PRNGKey(seed)
        r0 = jhmc.sample_momentum(key, jnp.asarray(inv_mass.numpy()), (3,),
                                  jnp.float64)
        monkeypatch.setattr(tadapt, "sample_momentum",
                            lambda *a: torch.tensor(np.asarray(r0)))
        ref = jadapt.find_reasonable_step_size(
            jvg, jstate, jnp.asarray(inv_mass.numpy()), key, step_size=eps0)
        mine = tadapt.find_reasonable_step_size(
            batched_vg, HMCState(z, logp, grad), inv_mass, None,
            step_size=eps0)
        assert mine == float(ref)
