"""JAX programs of the port's parity tests, compiled at XLA's backend
optimization level 0 (LLVM's, below the HLO passes): about a third less CPU
time to compile the tiny models' steps, and the same results within the
tests' tolerances."""

import jax

FAST = {"xla_backend_optimization_level": 0}


def fast(jitted):
    """`jitted` (a `jax.jit` function), compiled at `FAST` at its first call
    for each tree of argument shapes and dtypes, and reused after."""
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((getattr(x, "shape", None), str(getattr(x, "dtype", type(x))))
                           for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=FAST)
        return compiled[key](*args)

    return call
