"""A private build of the JAX package's host-ops library for the port's
parity tests.

``veto_tpu.native`` compiles its library into its own package directory, so
test processes that start together can write that one file at once.  These
tests compile the same source with the same command into a directory of
their own and point ``veto_tpu.native`` at it for the length of one test;
nothing under ``veto_tpu/`` is written or read back."""

import os
import subprocess

from veto_tpu import native as jnative


def build(directory) -> str:
    """Compile ``veto_tpu/native/host_ops.cpp`` as ``veto_tpu.native`` does."""
    path = os.path.join(str(directory), "libveto_host.so")
    subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
                    jnative._SRC, "-o", path],
                   check=True, capture_output=True, timeout=300)
    return path


def use(monkeypatch, path: str) -> None:
    """Load ``path`` as the JAX package's library until the test ends."""
    monkeypatch.setattr(jnative, "_LIB_PATH", path)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
