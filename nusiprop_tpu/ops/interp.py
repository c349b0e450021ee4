"""N-dimensional local-cubic spline interpolation via vectorized gathers.

Array-program equivalent of the reference's ``interp::spline_ND``
(interp.hpp:14-638): a cubic-Hermite scheme with finite-difference
tangents expressed as per-node weight polynomials over a <=4-node stencil
per axis (computeWeights, interp.hpp:576-636), tensor-multiplied across
dimensions (f_eval, interp.hpp:345-467). The weights are precomputed
host-side with numpy once per table; evaluation is a pure JAX function of
gathered table values, so it vectorizes over arbitrary batches of query
points and runs on-device (the per-step phi-phi kernel lookups become one
fused gather program).

Semantics matched to the reference:
  * per-axis optional log reparametrization of nodes and/or values
    (isLog, interp.hpp:73-76);
  * regular grids use O(1) index arithmetic with the same edge snapping
    (interp.hpp:366-374); irregular grids use searchsorted;
  * the stencil is 3 nodes at the first/last interval and 4 in the
    interior, with the same edge weight formulas;
  * out-of-range queries: the reference calls exit(1)
    (interp.hpp:354-361). Aborting is not expressible in compiled
    device code; we CLAMP the query to the valid open interval instead and
    expose ``out_of_bounds`` for callers that want to check. This is the
    documented deviation.
"""

import dataclasses
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SplineND", "build_spline", "load_binary_table"]


def _axis_weights(x: np.ndarray) -> np.ndarray:
    """Per-node weight tensor W[offset(4), coef(4), node] for one axis
    (transcription of computeWeights, interp.hpp:580-634; unused edge
    rows are zero so a fixed 4-node gather is safe)."""
    n = x.shape[0]
    W = np.zeros((4, 4, n), dtype=np.float64)
    for j in range(n - 1):
        if j == 0:
            W[0, :, j] = [0.0,
                          (x[j] - x[j + 1]) / (x[j] - x[j + 2]),
                          -1.0 + (x[j + 1] - x[j]) / (x[j] - x[j + 2]),
                          1.0]
            W[1, :, j] = [0.0,
                          (x[j + 1] - x[j]) / (x[j + 1] - x[j + 2]),
                          (x[j] - x[j + 2]) / (x[j + 1] - x[j + 2]),
                          0.0]
            W[2, :, j] = [0.0,
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 2] - x[j + 1]) * (x[j + 2] - x[j])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 2] - x[j + 1]) * (x[j] - x[j + 2])),
                          0.0]
        elif j == n - 2:
            W[0, :, j] = [0.0,
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j - 1] - x[j]) * (x[j - 1] - x[j + 1])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          0.0]
            W[1, :, j] = [0.0,
                          (x[j + 1] - x[j]) / (x[j - 1] - x[j]),
                          (2 * x[j] - x[j + 1] - x[j - 1]) / (x[j - 1] - x[j]),
                          1.0]
            W[2, :, j] = [0.0,
                          (x[j] - x[j + 1]) / (x[j - 1] - x[j + 1]),
                          (x[j - 1] - x[j]) / (x[j - 1] - x[j + 1]),
                          0.0]
        else:
            W[0, :, j] = [(x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          2 * (x[j + 1] - x[j]) ** 2
                          / ((x[j - 1] - x[j]) * (x[j - 1] - x[j + 1])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          0.0]
            W[1, :, j] = [(x[j] - x[j + 1])
                          * (1 / (x[j - 1] - x[j]) + 1 / (x[j] - x[j + 2])),
                          (x[j] - x[j + 1])
                          * (2 / (x[j] - x[j - 1]) + 1 / (x[j + 2] - x[j])),
                          (2 * x[j] - x[j + 1] - x[j - 1]) / (x[j - 1] - x[j]),
                          1.0]
            W[2, :, j] = [(x[j + 1] - x[j])
                          * (1 / (x[j - 1] - x[j + 1])
                             + 1 / (x[j + 1] - x[j + 2])),
                          (x[j + 1] - x[j])
                          * (2 / (x[j + 1] - x[j - 1])
                             + 1 / (x[j + 2] - x[j + 1])),
                          (x[j - 1] - x[j]) / (x[j - 1] - x[j + 1]),
                          0.0]
            W[3, :, j] = [(x[j + 1] - x[j]) ** 2
                          / ((-x[j + 1] + x[j + 2]) * (-x[j] + x[j + 2])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 1] - x[j + 2]) * (-x[j] + x[j + 2])),
                          0.0,
                          0.0]
    return W


@partial(jax.tree_util.register_dataclass,
         data_fields=("nodes", "weights", "values"),
         meta_fields=("regular", "log_axes", "log_value"))
@dataclasses.dataclass(frozen=True)
class SplineND:
    """Interpolation table as a pytree of device arrays.

    ``nodes``/``weights`` are per-axis (already log-reparametrized where
    requested); ``values`` is the full N-D value array (log-transformed
    if log_value). ``regular``/``log_axes``/``log_value`` are static
    (pytree metadata), so they stay concrete Python values under jit.
    """

    nodes: tuple          # per axis: (n_i,) float64
    weights: tuple        # per axis: (4, 4, n_i) float64
    values: jnp.ndarray   # (n_0, ..., n_{N-1})
    regular: bool
    log_axes: tuple       # per axis: bool (static)
    log_value: bool

    @property
    def ndim(self):
        return len(self.nodes)

    def astype(self, dtype):
        """Copy with ``values`` cast to ``dtype``.

        ``eval`` follows the values dtype for the stencil contraction
        (see eval), so ``astype(jnp.float32)`` turns the table into a
        float32 interpolator — the f32 path for the phi-phi kernel
        builds, where the 4^N-point gather-and-contract is the dominant
        op count. Nodes and weight tensors stay f64: the
        index arithmetic and weight polynomials are O(4N) per query
        versus the contraction's O(4^N) and keep full accuracy for free.
        """
        return dataclasses.replace(self, values=self.values.astype(dtype))

    def axis_index_weights(self, i, coords):
        """Stencil base index and 4-node polynomial weights along axis
        ``i`` at raw (pre-log) coordinates.

        Returns ``(base, p)`` with ``base`` of ``coords``' shape and
        ``p`` of shape ``(4,) + coords.shape`` (float64): the axis-``i``
        contribution to ``eval``'s tensor-product contraction,
        ``f = sum_o p[o] * values[..., base + o, ...]``.

        Exposed so callers whose queries form a separable grid (one
        coordinate list per axis) can contract axis by axis — each a
        small dense matmul — instead of gathering the full 4^N stencil
        per query point (the phi-phi kernel builders, kernels.py).
        Semantics (log reparametrization, clamping, edge snapping,
        base-index rule) are exactly ``eval``'s, which calls this.
        """
        x = self.nodes[i]
        c = jnp.asarray(coords, dtype=jnp.float64)
        c = jnp.log(jnp.maximum(c, 1e-300)) if self.log_axes[i] else c
        c = jnp.clip(c, x[0], x[-1])
        n = x.shape[0]
        if self.regular:
            k = jnp.floor((c - x[0]) / (x[1] - x[0])).astype(jnp.int32)
            # same edge snapping as interp.hpp:369-373
            k = jnp.where(c < x[1], 0, k)
            k = jnp.where(c > x[n - 2], n - 2, k)
        else:
            k = jnp.clip(jnp.searchsorted(x, c, side="right") - 1,
                         0, n - 2)
        t = (c - x[k]) / (x[k + 1] - x[k])
        W = self.weights[i][:, :, k]                       # (4, 4, ...)
        p = ((W[:, 0] * t + W[:, 1]) * t + W[:, 2]) * t + W[:, 3]
        # idx_min (interp.hpp:394-404): k at the left edge, else k-1.
        # The 4th stencil row is only populated for interior k, so a
        # fixed 4-offset gather with index clamping is exact: the
        # clamped (out-of-range) node meets a zero weight.
        base = jnp.where(k == 0, k, k - 1)
        return base, p

    def eval(self, *coords):
        """Interpolate at broadcastable coordinate arrays (one per axis).

        Out-of-range coordinates are clamped to the valid interval (the
        reference exits; see module docstring).
        """
        coords = [jnp.asarray(c, dtype=jnp.float64) for c in coords]
        coords = list(jnp.broadcast_arrays(*coords))
        # per-axis polynomial weights of the 4 stencil offsets; the
        # contraction below follows the VALUES dtype (astype docstring),
        # so the weights are cast here — a no-op for f64 tables.
        polys, bases = [], []
        for i in range(self.ndim):
            base, p = self.axis_index_weights(i, coords[i])
            polys.append(p.astype(self.values.dtype))      # (4, ...)
            bases.append(base)

        # gather the 4^N stencil and contract
        res = 0.0
        for flat in range(4 ** self.ndim):
            idx = []
            w = 1.0
            rem = flat
            for i in range(self.ndim):
                o = rem % 4
                rem //= 4
                n_i = self.nodes[i].shape[0]
                idx.append(jnp.minimum(bases[i] + o, n_i - 1))
                w = w * polys[i][o]
            res = res + w * self.values[tuple(idx)]
        return jnp.exp(res) if self.log_value else res

    def out_of_bounds(self, *coords):
        """True where the reference would exit(1) (interp.hpp:354-361)."""
        coords = [jnp.asarray(c, dtype=jnp.float64) for c in coords]
        oob = jnp.zeros(jnp.broadcast_shapes(*[c.shape for c in coords]),
                        dtype=bool)
        for i in range(self.ndim):
            x = self.nodes[i]
            c = jnp.log(jnp.maximum(coords[i], 1e-300)) if self.log_axes[i] \
                else coords[i]
            oob = oob | (c <= x[0]) | (c >= x[-1])
        return oob


def build_spline(nodes: Sequence[np.ndarray], values: np.ndarray,
                 regular: bool = False,
                 log_axes: Sequence[bool] = None,
                 log_value: bool = False) -> SplineND:
    """Build a SplineND from host arrays (cf. interp.hpp ctor :80-133)."""
    ndim = len(nodes)
    if log_axes is None:
        log_axes = (False,) * ndim
    xs = []
    for i, x in enumerate(nodes):
        x = np.asarray(x, dtype=np.float64)
        xs.append(np.log(x) if log_axes[i] else x)
    vals = np.asarray(values, dtype=np.float64)
    assert vals.shape == tuple(len(x) for x in xs)
    if log_value:
        vals = np.log(vals)
    weights = tuple(jnp.asarray(_axis_weights(x)) for x in xs)
    return SplineND(
        nodes=tuple(jnp.asarray(x) for x in xs),
        weights=weights,
        values=jnp.asarray(vals),
        regular=bool(regular),
        log_axes=tuple(bool(b) for b in log_axes),
        log_value=bool(log_value),
    )


def load_text_table(path: str, shape: Sequence[int],
                    regular: bool = True,
                    log_axes: Sequence[bool] = None,
                    log_value: bool = False) -> SplineND:
    """Load a reference-format text table (whitespace-separated rows of
    x_0 ... x_{N-1} f, '#' comment lines skipped, last axis fastest;
    interp.hpp:173-247) and build the interpolator.

    The reference interpolator accepts both text and binary files
    (interp.hpp:173-320); this is the text half — same row layout as
    load_binary_table but full-precision decimal instead of float32.
    """
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    raw = np.loadtxt(path, dtype=np.float64, comments="#")
    raw = raw.reshape(-1, ndim + 1)
    n_rows = int(np.prod(shape))
    if raw.shape[0] != n_rows:
        raise ValueError(
            f"{path}: expected {n_rows} rows for shape {shape}, "
            f"got {raw.shape[0]}")
    values = raw[:, -1].reshape(shape)
    nodes = []
    for i in range(ndim):
        stride = int(np.prod(shape[i + 1:]))
        nodes.append(raw[::stride, i][:shape[i]].copy())
    return build_spline(nodes, values, regular=regular, log_axes=log_axes,
                        log_value=log_value)


def load_binary_table(path: str, shape: Sequence[int],
                      regular: bool = True,
                      log_axes: Sequence[bool] = None,
                      log_value: bool = False) -> SplineND:
    """Load a reference-format binary table (float32 rows of
    x_0 ... x_{N-1} f, last axis fastest; interp.hpp:253-292 /
    text_to_binary.cpp) and build the interpolator."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, ndim + 1)
    n_rows = int(np.prod(shape))
    if raw.shape[0] != n_rows:
        raise ValueError(
            f"{path}: expected {n_rows} rows for shape {shape}, "
            f"got {raw.shape[0]}")
    values = raw[:, -1].astype(np.float64).reshape(shape)
    nodes = []
    for i in range(ndim):
        stride = int(np.prod(shape[i + 1:]))
        nodes.append(raw[::stride, i][:shape[i]].astype(np.float64))
    return build_spline(nodes, values, regular=regular, log_axes=log_axes,
                        log_value=log_value)
