# -*- coding: utf-8 -*-
"""Render per-kernel documentation straight from the DSL specs.

The reference generates its kernel docs from the same YAML that generates
the code (docs/user/kernels.rst.template:47-58 — the ``doc:`` blocks flow
into both), so the documentation cannot drift from the implementation.
This module is the analog: ``render_kernel_docs()`` turns every spec on
the search path into a markdown reference, ``python -m
george_tpu_torch.dsl.docgen`` writes ``docs/kernels_reference_torch.md``,
and ``tests/test_torch_aux.py`` fails whenever the committed file is
stale.
"""

import os

from .specs import load_specs

__all__ = ["render_kernel_docs", "DEFAULT_PATH"]

DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    ))),
    "docs", "kernels_reference_torch.md",
)

_HEADER = """\
# Built-in kernel reference

**Generated from the kernel DSL — do not edit.**  Every section below is
rendered from the same `george_tpu_torch/kernel_specs/*.yml` file that defines
the kernel's implementation (regenerate with
`python -m george_tpu_torch.dsl.docgen`; `tests/test_torch_aux.py` keeps this file
current in CI).  Math blocks use the reference's Sphinx notation; `r2`
is the metric-scaled squared distance of stationary kernels, and
non-stationary `value` expressions are per-axis scalar functions summed
over the kernel's `axes`.
"""


def _doc_block(doc):
    """Normalize a spec's RST ``doc:`` block for markdown output.

    Keep the text verbatim (the math is Sphinx ``.. math::`` — rendered
    literally, it is still the most precise statement of the kernel), but
    strip the uniform leading indentation YAML block scalars carry.
    """
    lines = doc.rstrip().splitlines()
    body = [ln for ln in lines if ln.strip()]
    if not body:
        return ""
    indent = min(len(ln) - len(ln.lstrip()) for ln in body)
    return "\n".join(ln[indent:] if ln.strip() else "" for ln in lines)


def render_kernel_docs(extra_paths=()):
    """Render the full markdown kernel reference as a string."""
    specs = sorted(
        load_specs(extra_paths).values(), key=lambda s: s.kernel_type
    )
    out = [_HEADER]
    for s in specs:
        out.append("\n## `{0}` (kernel_type {1})\n".format(
            s.name, s.kernel_type
        ))
        out.append("- **stationary:** {0}".format(
            "yes (value is a function of `r2` through the metric)"
            if s.stationary else "no (per-axis function of `x1`, `x2`)"
        ))
        out.append("- **parameters:** {0}".format(
            ", ".join("`{0}`".format(p) for p in s.params) or "*(none)*"
        ))
        if s.constants:
            out.append("- **constants:** {0}".format(", ".join(
                "`{0}` ({1})".format(n, t) for n, t in s.constants
            )))
        if s.reparams:
            out.append("- **reparams:** {0}".format("; ".join(
                "`{0} = {1}`".format(n, e) for n, e in s.reparams
            )))
        out.append("- **value:** `{0}`".format(s.value.replace("\n", " ")))
        grads = s.grad_dict
        if grads:
            out.append(
                "- **closed-form gradients** (cross-checked against "
                "autodiff in `tests/test_dsl.py`): {0}".format(
                    ", ".join("`{0}`".format(k) for k in sorted(grads))
                )
            )
        doc = _doc_block(s.doc)
        if doc:
            out.append("\n```rst\n{0}\n```".format(doc))
    out.append("")
    return "\n".join(out)


def main(path=None):
    path = path or DEFAULT_PATH
    text = render_kernel_docs()
    with open(path, "w") as f:
        f.write(text)
    print("wrote {0}".format(path))


if __name__ == "__main__":
    main()
