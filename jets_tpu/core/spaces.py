"""Vector spaces — the L0 layer of the framework.

JAX re-design of the reference's space protocol (Jets.jl
``JetAbstractSpace`` / ``JetSpace``, ``src/Jets.jl:5-129``): a *space* is a
static description ``(shape, dtype)`` of where model/data vectors live. Spaces
are immutable, hashable, and act as pytree *aux data*, so operators carrying
them trace cleanly under ``jax.jit``.

Differences from the reference, by design (functional JAX):

* allocators that draw random numbers take an explicit ``jax.random`` key
  (``rand(key, space)``), never global RNG state;
* ``reshape(x, space)`` is a pure function returning a new array (no views of
  mutable state — XLA fuses the reshape away);
* norms/inner products are defined *by the space* so symmetric (rfft-style)
  spaces can weight the stored half correctly (reference ``JetSSpace``,
  ``src/Jets.jl:406-516``).
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Space",
    "SymmetricSpace",
    "MappedSymmetricSpace",
    "symspace",
    "space_of",
    "zeros",
    "ones",
    "rand",
    "randn",
    "reshape",
    "randperm",
]


def _canon_shape(shape: Sequence[int] | int) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


class Space:
    """A dense n-D vector space: ``(shape, dtype)``.

    Mirrors the reference ``JetSpace`` (``src/Jets.jl:40-129``): carries element
    type and shape, provides allocators and ``reshape``. Hashable and
    comparable by value so it can live in pytree aux data / jit static args.
    """

    __slots__ = ("_shape", "_dtype")

    def __init__(self, shape: Sequence[int] | int, dtype: Any = jnp.float32):
        object.__setattr__(self, "_shape", _canon_shape(shape))
        object.__setattr__(self, "_dtype", jnp.dtype(dtype))

    # -- immutability ------------------------------------------------------
    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("Space is immutable")

    # -- protocol (reference: eltype :12, ndims :15, length :22, size :30) --
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        """Total number of elements (reference ``length``)."""
        return int(math.prod(self._shape))

    def __len__(self) -> int:
        return self.size

    # -- identity ----------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self._shape == other._shape
            and self._dtype == other._dtype
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._shape, str(self._dtype)))

    def __repr__(self) -> str:
        return f"Space({self._shape}, {self._dtype.name})"

    # -- allocators (reference ``ones/rand/randn/zeros`` :105-107) ----------
    def zeros(self) -> jax.Array:
        return jnp.zeros(self._shape, self._dtype)

    def ones(self) -> jax.Array:
        return jnp.ones(self._shape, self._dtype)

    def rand(self, key: jax.Array) -> jax.Array:
        """Uniform [0,1) member (complex spaces: complex uniform)."""
        if jnp.issubdtype(self._dtype, jnp.complexfloating):
            rk, ik = jax.random.split(key)
            real_dt = jnp.float32 if self._dtype == jnp.complex64 else jnp.float64
            re = jax.random.uniform(rk, self._shape, real_dt)
            im = jax.random.uniform(ik, self._shape, real_dt)
            return jax.lax.complex(re, im).astype(self._dtype)
        if jnp.issubdtype(self._dtype, jnp.integer):
            return jax.random.randint(key, self._shape, 0, 2**30).astype(self._dtype)
        return jax.random.uniform(key, self._shape, self._dtype)

    def randn(self, key: jax.Array) -> jax.Array:
        if jnp.issubdtype(self._dtype, jnp.complexfloating):
            rk, ik = jax.random.split(key)
            real_dt = jnp.float32 if self._dtype == jnp.complex64 else jnp.float64
            scale = np.sqrt(0.5).astype(real_dt)
            re = jax.random.normal(rk, self._shape, real_dt) * scale
            im = jax.random.normal(ik, self._shape, real_dt) * scale
            return jax.lax.complex(re, im).astype(self._dtype)
        return jax.random.normal(key, self._shape, self._dtype)

    # -- membership / reshape (reference ``reshape`` :38) -------------------
    def reshape(self, x) -> jax.Array:
        """View ``x`` as a member of this space (pure)."""
        x = jnp.asarray(x)
        if x.size != self.size:
            raise ValueError(f"cannot reshape size-{x.size} array into {self}")
        return jnp.reshape(x, self._shape).astype(self._dtype)

    def ravel(self, x) -> jax.Array:
        """Flatten a member to a 1-D vector (bridge for 1-D-only consumers)."""
        return jnp.reshape(x, (-1,))

    def shape_dtype(self) -> jax.ShapeDtypeStruct:
        return jax.ShapeDtypeStruct(self._shape, self._dtype)

    # -- inner products / norms --------------------------------------------
    # The space owns the inner product so weighted spaces (SymmetricSpace,
    # BlockSpace) can override. <x, y> is conjugate-linear in x.
    def dot(self, x, y):
        return jnp.vdot(x, y)

    def norm(self, x, p: float = 2):
        xf = jnp.ravel(x)
        if p == 2:
            return jnp.sqrt(jnp.real(jnp.vdot(xf, xf)))
        a = jnp.abs(xf)
        if p == float("inf"):
            return jnp.max(a)
        if p == float("-inf"):
            return jnp.min(a)
        if p == 0:
            return jnp.sum(a != 0).astype(jnp.result_type(a, jnp.float32))
        return jnp.sum(a**p) ** (1.0 / p)


class SymmetricSpace(Space):
    """Space with Hermitian symmetry along one axis — rfft ranges.

    JAX counterpart of the reference ``JetSSpace``/``SymmetricArray``
    (``src/Jets.jl:406-516``). The reference stores only the non-redundant
    half of a complex array whose full version is Hermitian-symmetric, and
    *doubles the reflected half in norms/dots* (pinned by
    ``test/runtests.jl:243-248``).

    Here members are plain complex arrays of the *stored* (``jnp.fft.rfftn``
    output) shape; ``logical_shape`` is the full real-transform length. Inner
    products weight each stored element by its multiplicity in the logical
    array (1 for self-conjugate bins, 2 otherwise), so operator adjoints built
    against this space pass the dot-product test exactly as full-spectrum
    operators would.
    """

    __slots__ = ("_logical_shape", "_axis")

    def __init__(
        self,
        stored_shape: Sequence[int] | int,
        logical_shape: Sequence[int] | int,
        dtype: Any = jnp.complex64,
        axis: int = -1,
    ):
        super().__init__(stored_shape, dtype)
        object.__setattr__(self, "_logical_shape", _canon_shape(logical_shape))
        ax = axis % len(self._shape)
        object.__setattr__(self, "_axis", ax)
        n_log = self._logical_shape[ax]
        if self._shape[ax] != n_log // 2 + 1:
            raise ValueError(
                f"stored axis {ax} has {self._shape[ax]} elements; expected "
                f"{n_log // 2 + 1} for logical length {n_log}"
            )

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return self._logical_shape

    @property
    def axis(self) -> int:
        return self._axis

    def _weights(self) -> jax.Array:
        """Per-element multiplicity of each stored bin in the logical array."""
        n_log = self._logical_shape[self._axis]
        n_sto = self._shape[self._axis]
        idx = jnp.arange(n_sto)
        # bin 0 and (if n_log even) the Nyquist bin are self-conjugate.
        w = jnp.where((idx == 0) | ((n_log % 2 == 0) & (idx == n_sto - 1)), 1.0, 2.0)
        shape = [1] * len(self._shape)
        shape[self._axis] = n_sto
        return w.reshape(shape)

    def dot(self, x, y):
        """Inner product equal to the FULL logical-spectrum dot for
        Hermitian-symmetric members: each doubled bin pair contributes
        ``2·Re(conj(x)·y)`` (the pair's imaginary parts cancel in the
        logical array), self-conjugate bins contribute fully."""
        w = self._weights()
        z = jnp.conj(x) * y
        re = jnp.sum(w * jnp.real(z))
        im = jnp.sum(jnp.where(w == 1.0, jnp.imag(z), 0.0))
        return (re + 1j * im).astype(self._dtype)

    def norm(self, x, p: float = 2):
        w = jnp.broadcast_to(self._weights(), jnp.shape(x))
        if p == 2:
            return jnp.sqrt(jnp.sum(w * jnp.abs(x) ** 2))
        a = jnp.abs(x)
        if p == float("inf"):
            return jnp.max(a)
        if p == float("-inf"):
            return jnp.min(a)
        if p == 0:
            return jnp.sum(w * (a != 0))
        return jnp.sum(w * a**p) ** (1.0 / p)

    def __eq__(self, other) -> bool:
        return (
            super().__eq__(other)
            and self._logical_shape == other._logical_shape
            and self._axis == other._axis
        )

    def __hash__(self) -> int:
        return hash((super().__hash__(), self._logical_shape, self._axis))

    def __repr__(self) -> str:
        return (
            f"SymmetricSpace(stored={self._shape}, logical={self._logical_shape}, "
            f"{self._dtype.name})"
        )

    # -- logical view (reference ``SymmetricArray`` reads past the stored
    # region return conjugates, src/Jets.jl:443-516; here the expansion is a
    # pure function instead of a lazy container) ---------------------------
    def to_logical(self, x) -> jax.Array:
        """Expand a stored member to the FULL logical spectrum: the missing
        bins ``k > n//2`` on the symmetric axis are ``conj`` of the stored
        bins with every axis modularly reflected (``i -> (n - i) % n``) —
        exactly the n-D DFT Hermitian symmetry, so
        ``to_logical(rfftn(x)) == fftn(x)`` for real ``x``. Cheap slicing
        and flips, no gather tables."""
        ax = self._axis
        n_log = self._logical_shape[ax]
        h = n_log // 2
        # mirrored source bins on the symmetric axis: 1..h-1 (even n) or
        # 1..h (odd n), read in reverse
        jhi = h if n_log % 2 == 0 else h + 1
        sl = [slice(None)] * self.ndim
        sl[ax] = slice(1, jhi)
        tail = jnp.conj(x[tuple(sl)])
        tail = jnp.flip(tail, axis=ax)
        # modular reflection i -> (n - i) % n on every OTHER axis
        for oax in range(self.ndim):
            if oax != ax:
                tail = jnp.roll(jnp.flip(tail, axis=oax), 1, axis=oax)
        return jnp.concatenate([x, tail], axis=ax)

    def from_logical(self, y) -> jax.Array:
        """Crop a full logical spectrum back to the stored half (left
        inverse of :meth:`to_logical`)."""
        sl = [slice(None)] * self.ndim
        sl[self._axis] = slice(0, self._shape[self._axis])
        return y[tuple(sl)].astype(self._dtype)


class MappedSymmetricSpace(Space):
    """Space with an ARBITRARY Hermitian-redundancy index map — the
    reference's author hook generalized (``JetSSpace`` takes any map ``F``
    and operator authors register theirs via ``symspace()``,
    ``src/Jets.jl:408-441``).

    Members are plain arrays of the *stored* shape (an axes-aligned prefix
    box of the logical shape, as in the reference's ``SymmetricArray``
    whose reads past the stored region return ``conj(A[F(I)])``,
    ``src/Jets.jl:443-516``). ``index_map`` is a vectorized callable:
    given a tuple of numpy index arrays for logical positions OUTSIDE the
    stored box, it returns the tuple of stored indices whose conjugates
    live there.

    Inner products and norms weight each stored element by its multiplicity
    in the logical array, so ``dot(x, y)`` equals the full logical-spectrum
    ``vdot(to_logical(x), to_logical(y))`` exactly — operator adjoints
    built against this space pass the dot-product gate as full-spectrum
    operators would (the reference's doubled-norm semantics,
    ``test/runtests.jl:243-248``, for arbitrary maps).

    The symmetry tables are computed once with numpy at construction and
    enter traced programs as constants — intended for author-defined
    transform ranges, not multi-GB grids (use :class:`SymmetricSpace` for
    the rfft case, which needs no tables).
    """

    __slots__ = ("_logical_shape", "_map_fn", "_src", "_nmirror")

    def __init__(
        self,
        stored_shape: Sequence[int] | int,
        logical_shape: Sequence[int] | int,
        dtype: Any = jnp.complex64,
        index_map=None,
    ):
        super().__init__(stored_shape, dtype)
        object.__setattr__(self, "_logical_shape", _canon_shape(logical_shape))
        if len(self._logical_shape) != len(self._shape):
            raise ValueError("stored/logical ndim mismatch")
        if any(s > m for s, m in zip(self._shape, self._logical_shape)):
            raise ValueError("stored box must fit inside the logical shape")
        if index_map is None:
            raise ValueError("index_map is required (the symspace hook)")
        object.__setattr__(self, "_map_fn", index_map)

        grids = np.meshgrid(
            *[np.arange(M) for M in self._logical_shape], indexing="ij"
        )
        in_stored = np.ones(self._logical_shape, bool)
        for g, s in zip(grids, self._shape):
            in_stored &= g < s
        out_idx = tuple(g[~in_stored] for g in grids)
        src = np.empty(self._logical_shape, np.int64)
        own = tuple(g[in_stored] for g in grids)
        src[in_stored] = np.ravel_multi_index(own, self._shape)
        if out_idx[0].size:
            mapped = index_map(out_idx)
            mapped = tuple(np.asarray(m) for m in mapped)
            for m, s in zip(mapped, self._shape):
                if np.any((m < 0) | (m >= s)):
                    raise ValueError(
                        "index_map must land inside the stored box"
                    )
            src[~in_stored] = np.ravel_multi_index(mapped, self._shape)
        # per-stored-element count of mirrored logical positions
        nmirror = np.bincount(
            src[~in_stored].ravel(), minlength=self.size
        ).reshape(self._shape)
        object.__setattr__(self, "_src", src)
        object.__setattr__(self, "_nmirror", nmirror)

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return self._logical_shape

    # -- weighted inner product: <x,y>_logical = sum_stored z + sum_mirror
    # conj(z_src) with z = conj(x) y, so each stored element contributes
    # (1 + c) Re(z) + i (1 - c) Im(z) for c mirrored copies ----------------
    def dot(self, x, y):
        c = jnp.asarray(self._nmirror, jnp.real(jnp.zeros((), self._dtype)).dtype)
        z = jnp.conj(x) * y
        re = jnp.sum((1.0 + c) * jnp.real(z))
        im = jnp.sum((1.0 - c) * jnp.imag(z))
        return (re + 1j * im).astype(self._dtype)

    def norm(self, x, p: float = 2):
        w = 1.0 + jnp.asarray(
            self._nmirror, jnp.real(jnp.zeros((), self._dtype)).dtype
        )
        a = jnp.abs(x)
        if p == 2:
            return jnp.sqrt(jnp.sum(w * a**2))
        if p == float("inf"):
            return jnp.max(a)
        if p == float("-inf"):
            return jnp.min(a)
        if p == 0:
            return jnp.sum(w * (a != 0))
        return jnp.sum(w * a**p) ** (1.0 / p)

    # -- logical view -------------------------------------------------------
    def to_logical(self, x) -> jax.Array:
        """Materialize the full logical array: gather each logical position
        from its stored source, conjugating the mirrored ones."""
        flat = jnp.take(jnp.ravel(x), jnp.asarray(self._src.ravel()))
        in_stored = np.ones(self._logical_shape, bool)
        grids = np.meshgrid(
            *[np.arange(M) for M in self._logical_shape], indexing="ij"
        )
        for g, s in zip(grids, self._shape):
            in_stored &= g < s
        mask = jnp.asarray(in_stored.ravel())
        flat = jnp.where(mask, flat, jnp.conj(flat))
        return jnp.reshape(flat, self._logical_shape)

    def from_logical(self, y) -> jax.Array:
        """Crop a logical array back to the stored box."""
        sl = tuple(slice(0, s) for s in self._shape)
        return y[sl].astype(self._dtype)

    def __eq__(self, other) -> bool:
        return (
            super().__eq__(other)
            and self._logical_shape == other._logical_shape
            and self._map_fn is other._map_fn
        )

    def __hash__(self) -> int:
        return hash(
            (super().__hash__(), self._logical_shape, id(self._map_fn))
        )

    def __repr__(self) -> str:
        return (
            f"MappedSymmetricSpace(stored={self._shape}, "
            f"logical={self._logical_shape}, {self._dtype.name})"
        )


def symspace(
    stored_shape: Sequence[int] | int,
    logical_shape: Sequence[int] | int,
    dtype: Any = jnp.complex64,
    index_map=None,
) -> MappedSymmetricSpace:
    """Author hook for registering a custom Hermitian-redundant space — the
    reference's ``symspace()`` (``src/Jets.jl:441``): operator authors whose
    ranges store only the non-redundant half of a symmetric transform build
    their range space here by supplying the index map."""
    return MappedSymmetricSpace(stored_shape, logical_shape, dtype, index_map)


# -- free-function API (parity with reference module-level verbs) -----------

def space_of(x, *, dtype=None) -> Space:
    """Infer the space an array belongs to (reference ``space`` :126-129)."""
    x = jnp.asarray(x)
    return Space(x.shape, dtype or x.dtype)


def zeros(space: Space) -> jax.Array:
    return space.zeros()


def ones(space: Space) -> jax.Array:
    return space.ones()


def rand(key: jax.Array, space: Space) -> jax.Array:
    return space.rand(key)


def randn(key: jax.Array, space: Space) -> jax.Array:
    return space.randn(key)


def reshape(x, space: Space) -> jax.Array:
    return space.reshape(x)


def randperm(key: jax.Array, space: Space, k: int | None = None):
    """Random permutation of linear indices of ``space``; a SORTED k-sample
    if ``k`` is given — the reference returns ``sort`` of the first ``k``
    draws (``src/Jets.jl:124``), and downstream masking/restriction ops rely
    on monotone index lists."""
    p = jax.random.permutation(key, space.size)
    return p if k is None else jnp.sort(p[:k])
