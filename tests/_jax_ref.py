"""The JAX package's side of the port's parity tests.

JAX references are compiled without XLA's algebraic simplifier: it turns
divisions by constants into multiplications one ulp apart, where eager JAX
and the port both divide.  A function that ``jit_dividing`` returns keeps
what it compiled: called again at the same shapes and dtypes, it is not
compiled again.  A new function, a new lambda included, is compiled anew.
"""

import jax
import jax.numpy as jnp
import numpy as np

WITHOUT_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


def jit_dividing(fn):
    """``jax.jit(fn)`` without XLA's algebraic simplifier."""
    return jax.jit(fn, compiler_options=WITHOUT_ALGSIMP)


def jit_without_algsimp(decoded):
    """A stand-in for ``jax.jit`` that compiles ``infer`` on float64
    inputs without the algebraic simplifier, recording its outputs."""
    real_jit = jax.jit

    def jit(fn):
        if fn.__name__ != "infer":
            return real_jit(fn)
        compiled = real_jit(fn, compiler_options=WITHOUT_ALGSIMP)

        def run(*args):
            args = jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64)
                if np.asarray(a).dtype == np.float32 else jnp.asarray(a),
                args)
            out = compiled(*args)
            decoded.append(jax.device_get(out))
            return out
        return run
    return jit
