"""jets_tpu — a matrix-free operator-and-solver framework.

A from-scratch JAX/XLA re-design with the capabilities of
ChevronETC/Jets.jl:

* **L0 spaces** (``core.spaces``, ``core.blockspace``) — dense, symmetric
  (rfft), and block vector spaces with space-owned inner products;
* **L1 jet core** (``core.jet``) — immutable (function, linearization point)
  records; operators are pytrees flowing through ``jit``/``vmap``/``shard_map``;
  adjoints derived via ``jax.linear_transpose`` unless overridden;
* **L2 algebra** (``core.algebra``, ``core.block``) — composition, sums,
  scaling, vec, block operators with structural-zero elision;
* **L3 verification** (``core.verify``) — dot-product / linearity /
  linearization gates, dense materialization;
* **ops** — diagonal, matrix, convolution/derivative, FFT (symmetric space),
  stencils and the wave-equation propagators;
* **solvers** — CG / CGLS / LSQR as ``lax.while_loop`` XLA programs;
* **parallel** — mesh-sharded block operators with ``psum`` adjoint
  accumulation over the device mesh.
"""
from .core.spaces import (
    Space,
    SymmetricSpace,
    MappedSymmetricSpace,
    symspace,
    space_of,
    zeros,
    ones,
    rand,
    randn,
    reshape,
    randperm,
)
from .core.blockspace import BlockSpace, BlockVector
from .core.jet import (
    Jet,
    Operator,
    LinearOperator,
    AdjointOperator,
    jet_of,
    point,
    linearize,
    jacobian,
    adjoint,
    state,
    with_state,
    perfstat,
    close,
)
from .core.algebra import compose, add, subtract, scale, vec, is_composite, is_sum
from .core.block import (
    block_operator,
    zero_block,
    is_zero_block,
    is_block_op,
    nblocks,
    getblock,
)
from .core.verify import (
    dot_product_test,
    linearity_test,
    linearization_test,
    materialize,
)
from . import utils  # noqa: E402  (jt.utils.<...> — checkpoint, codec, ...)

__version__ = "0.1.0"
