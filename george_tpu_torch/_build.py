# -*- coding: utf-8 -*-
"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each kernel source under ``csrc/`` has a plain C interface.  One shared
library is built per instantiation, at first use, into the build directory.
An instantiation is a source, a set of ``-D`` macros and, for a kernel that
includes generated code (the dense kernel's tree, the covariance kernel's
radial function: ``dsl/cuda_codegen.py``), the text of the generated
headers: they are written beside the library and put on the include path.  The library is named by a hash of the source, the
shared headers of ``csrc/``, the generated text and the full flag list, so a
changed source, header, tree or flag set never loads a stale library, and
two trees never share one.  Builds of several instantiations run in
parallel (one ``nvcc`` each, all started together).  Nothing here runs at
import time.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["Instance", "build_dir", "build_many", "build_seconds", "load",
           "ptxas_report"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v", "-I", _CSRC]

_LOADED = {}
# Wall seconds of each library's nvcc run in this process, by path.
_SECONDS = {}


class Instance(object):
    """One instantiation: ``source`` (a file of ``csrc/``), its ``-D``
    macros and its generated headers (``{file name: text}``)."""

    def __init__(self, source, defines, headers=None):
        self.source = source
        self.defines = dict(defines)
        self.headers = dict(headers or {})

    def key(self):
        return (self.source, tuple(sorted(self.defines.items())),
                tuple(sorted(self.headers.items())))


def build_dir():
    """``build/george_tpu_torch`` next to the package (the checkout's root
    when run from a checkout)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "build", "george_tpu_torch")


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(inst):
    """(source path, flags, library, log, generated-header directory)."""
    src = os.path.join(_CSRC, inst.source)
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    for name, text in sorted(inst.headers.items()):
        h.update(b"\0" + name.encode() + b"\0" + text.encode())
    flags = _ARCH + _FLAGS + ["-D{0}={1}".format(k, v)
                              for k, v in sorted(inst.defines.items())]
    h.update("\0".join(flags).encode())
    stem = os.path.join(build_dir(), "{0}_{1}".format(
        os.path.splitext(inst.source)[0], h.hexdigest()[:16]))
    gen = stem + "_gen"
    if inst.headers:
        flags = flags + ["-I", gen]
    return src, flags, stem + ".so", stem + ".log", gen


def build_many(instances):
    """Build every instantiation not yet on disk, all in parallel.

    :returns: the list of library paths, in order.
    """
    os.makedirs(build_dir(), exist_ok=True)
    jobs, libs = [], []
    for inst in instances:
        src, flags, lib, log, gen = _paths(inst)
        libs.append(lib)
        if os.path.exists(lib) or any(j[1] == lib for j in jobs):
            continue
        if inst.headers:
            os.makedirs(gen, exist_ok=True)
            for name, text in inst.headers.items():
                with open(os.path.join(gen, name), "w") as f:
                    f.write(text)
        # Unique per process and thread: concurrent builds of one library
        # each write their own file, and the last rename wins.
        tmp = "{0}.tmp{1}_{2}".format(lib, os.getpid(), threading.get_ident())
        cmd = [_nvcc()] + flags + ["-o", tmp, src]
        out = open(log, "wb")
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        jobs.append((proc, lib, log, tmp, cmd, out, time.time()))
    pending = list(jobs)
    while pending:
        for job in list(pending):
            if job[0].poll() is not None:
                _SECONDS[job[1]] = time.time() - job[6]
                job[5].close()
                pending.remove(job)
        if pending:
            time.sleep(0.05)
    failures = []
    for proc, lib, log, tmp, cmd, _, _ in jobs:
        if proc.returncode != 0:
            with open(log, errors="replace") as f:
                failures.append("{0}\n{1}".format(" ".join(cmd), f.read()))
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def load(inst):
    """The loaded library of one :class:`Instance` (built on first use)."""
    key = inst.key()
    lib = _LOADED.get(key)
    if lib is None:
        path = build_many([inst])[0]
        lib = ctypes.CDLL(path)
        _LOADED[key] = lib
    return lib


def build_seconds(inst):
    """Wall seconds of the ``nvcc`` run that built ``inst`` in this process
    (None if it was on disk already)."""
    return _SECONDS.get(_paths(inst)[2])


def ptxas_report(inst):
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of a
    built :class:`Instance`."""
    log = _paths(inst)[3]
    with open(log, errors="replace") as f:
        return [line.strip() for line in f
                if "ptxas info" in line or "bytes stack frame" in line]
