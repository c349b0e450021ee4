"""Double-scalar-production (phi-phi) cross-section tables.

The reference precomputes two tables offline (xsec/tables_phiphi.py) and
interpolates them at kernel-build time (nuSIprop.hpp:166-170, 1199, 1483):

  * alphatilde_phiphi: 2-D, axes (|tbar_plus| log-spaced in [4, 1e4],
    log10 delta in [0.005, 0.05]), 5000 x 100 at reference resolution.
  * alpha_phiphi: 3-D, axes (sbar_plus log-spaced in [4, 1e4],
    n = log(sbar_minus/|tbar_minus|)/log(delta) in [1, 1000],
    log10 delta in [0.005, 0.05]), 1000 x 1000 x 100 at reference
    resolution.

``PPTables`` wraps both as SplineND pytrees; the eval methods implement
the exact lookup coordinates of the reference (including the 1.0001
factor on the n coordinate and |.| on the alpha value, nuSIprop.hpp:1483).

Tables load either from reference-format float32 ``.bin`` files
(text_to_binary.cpp layout) or from ``.npz`` files written by
``tools/make_tables.py`` (the on-device regeneration pipeline).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from nusiprop_tpu.ops import interp

# Reference grid specs (xsec/tables_phiphi.py:21-23, 39-41)
REF_ALPHATILDE_SHAPE = (5000, 100)
REF_ALPHA_SHAPE = (1000, 1000, 100)


class PPTables(NamedTuple):
    alphatilde: interp.SplineND  # 2-D
    alpha: interp.SplineND       # 3-D

    def eval_alphatilde(self, abs_tplus, log10_delta):
        """spl_alphaTilde_phiphi.f_eval({-tplus, log10(tplus/tminus)})
        (nuSIprop.hpp:1199)."""
        return self.alphatilde.eval(abs_tplus, log10_delta)

    def eval_alpha(self, sminus_prime, n_coord, log10_delta):
        """spl_alpha_phiphi.f_eval({sminus', log(-sminus'/tminus)/log(delta)
        * 1.0001, log10(delta)}) — the caller supplies n_coord already
        scaled by 1.0001 (kernels_nr.alpha_pp)."""
        return self.alpha.eval(sminus_prime, n_coord, log10_delta)


def load_binary(alphatilde_path: str, alpha_path: str,
                alphatilde_shape=REF_ALPHATILDE_SHAPE,
                alpha_shape=REF_ALPHA_SHAPE) -> PPTables:
    """Load reference-format .bin tables (nuSIprop.hpp:168-169 specs:
    regular grids, first axis logarithmic, linear values)."""
    at = interp.load_binary_table(alphatilde_path, alphatilde_shape,
                                  regular=True,
                                  log_axes=[True, False, False])
    a = interp.load_binary_table(alpha_path, alpha_shape, regular=True,
                                 log_axes=[True, False, False, False])
    return PPTables(alphatilde=at, alpha=a)


def load_text(alphatilde_path: str, alpha_path: str,
              alphatilde_shape=REF_ALPHATILDE_SHAPE,
              alpha_shape=REF_ALPHA_SHAPE) -> PPTables:
    """Load reference-format .dat text tables (the tables_phiphi.py
    output the reference converts with text_to_binary.cpp; the reference
    interpolator reads this format directly too, interp.hpp:173-247)."""
    at = interp.load_text_table(alphatilde_path, alphatilde_shape,
                                regular=True,
                                log_axes=[True, False, False])
    a = interp.load_text_table(alpha_path, alpha_shape, regular=True,
                               log_axes=[True, False, False, False])
    return PPTables(alphatilde=at, alpha=a)


def load_npz(path: str) -> PPTables:
    """Load tables from the make_tables.py .npz container."""
    d = np.load(path)
    at = interp.build_spline(
        [d["at_tplus"], d["at_log10d"]], d["at_values"], regular=True,
        log_axes=[True, False])
    a = interp.build_spline(
        [d["a_splus"], d["a_n"], d["a_log10d"]], d["a_values"],
        regular=True, log_axes=[True, False, False])
    return PPTables(alphatilde=at, alpha=a)


def save_npz(path: str, at_tplus, at_log10d, at_values,
             a_splus, a_n, a_log10d, a_values):
    np.savez_compressed(
        path,
        at_tplus=np.asarray(at_tplus), at_log10d=np.asarray(at_log10d),
        at_values=np.asarray(at_values),
        a_splus=np.asarray(a_splus), a_n=np.asarray(a_n),
        a_log10d=np.asarray(a_log10d), a_values=np.asarray(a_values),
    )


def load_default() -> PPTables:
    """Locate and load the phi-phi tables.

    Search order:
      1. ``$NUSIPROP_PP_TABLES`` — path to a make_tables.py .npz;
      2. ``$NUSIPROP_PP_TABLES_BIN`` — directory holding the
         reference-format ``alphatilde_phiphi.bin``/``alpha_phiphi.bin``
         (reference resolution assumed, nuSIprop.hpp:168-169);
      3. ``data/pp_tables*.npz`` next to the package; when several
         resolutions are present the largest file (finest grid) wins.

    The repo ships the medium-resolution tables (1000x50 + 300x300x50;
    end-to-end flux delta vs full resolution 1.5e-5, ~70x inside the
    1e-3 physics gate — tools/validate_full_tables.py). Full
    REFERENCE-resolution tables (5000x100 + 1000x1000x100,
    xsec/tables_phiphi.py:21-59) regenerate on one accelerator with:

        python tools/make_tables.py --preset full --chunk 131072 \\
               --out data/pp_tables_full.npz

    after which this loader picks them up automatically (largest file
    wins). The 800 MB artifact is .gitignored, not distributed — unlike
    the reference, whose full tables are "available upon request"
    (README.md:52), regeneration here is self-service.

    The reference exits at construction when its .bin files are missing
    (interp.hpp:203-206); we raise with the regeneration command instead.
    """
    import glob
    import os

    env = os.environ.get("NUSIPROP_PP_TABLES")
    if env:
        return load_npz(env)
    env = os.environ.get("NUSIPROP_PP_TABLES_BIN")
    if env:
        return load_binary(os.path.join(env, "alphatilde_phiphi.bin"),
                           os.path.join(env, "alpha_phiphi.bin"))
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    hits = glob.glob(os.path.join(pkg_root, "data", "pp_tables*.npz"))
    if hits:
        # highest resolution wins: the biggest file is the finest table
        return load_npz(max(hits, key=os.path.getsize))
    raise FileNotFoundError(
        "phi-phi cross-section tables not found. Generate them with\n"
        "  python tools/make_tables.py --out data/pp_tables.npz\n"
        "or point NUSIPROP_PP_TABLES at an .npz / NUSIPROP_PP_TABLES_BIN "
        "at a directory with the reference .bin files.")


def save_binary(alphatilde_path, alpha_path, at_tplus, at_log10d,
                at_values, a_splus, a_n, a_log10d, a_values):
    """Write the reference float32 row format (text_to_binary.cpp)."""
    at_values = np.asarray(at_values)
    n0, n1 = at_values.shape
    rows = np.empty((n0 * n1, 3), dtype=np.float32)
    rows[:, 0] = np.repeat(np.asarray(at_tplus), n1)
    rows[:, 1] = np.tile(np.asarray(at_log10d), n0)
    rows[:, 2] = at_values.reshape(-1)
    rows.tofile(alphatilde_path)

    a_values = np.asarray(a_values)
    m0, m1, m2 = a_values.shape
    rows = np.empty((m0 * m1 * m2, 4), dtype=np.float32)
    rows[:, 0] = np.repeat(np.asarray(a_splus), m1 * m2)
    rows[:, 1] = np.tile(np.repeat(np.asarray(a_n), m2), m0)
    rows[:, 2] = np.tile(np.asarray(a_log10d), m0 * m1)
    rows[:, 3] = a_values.reshape(-1)
    rows.tofile(alpha_path)
