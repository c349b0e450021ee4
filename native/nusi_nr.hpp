// nusi_nr.hpp — non-resonant channel closed forms for the native serial
// engine (t, u, t-u interference, s-t/s-u interference; phiphi excluded —
// it needs the offline spline tables).
//
// Scalar C++ transcription of the engine's own float64 channel library
// (nusiprop_tpu/models/kernels_nr.py, itself built from
// nuSIprop.hpp:796-918, 975-1192, 1280-1474), including the reference's
// Taylor guards, the "negative => 3-pt Gauss-Legendre rescue" fallbacks,
// the alpha_tu rescue-shadowing quirk, and the coordinate floor. The
// special functions mirror ops/specfun.py (which replaces GSL/the
// polylogarithm library on the device).

#pragma once

#include <cmath>
#include <complex>

namespace nusi {
namespace nr {

using cd = std::complex<double>;

constexpr double NR_PI = 3.141592653589793;
constexpr double NR_PI2_6 = 1.6449340668482264;
constexpr double TINY = 1e-30;
constexpr double COORD_FLOOR = 1e-8;

inline double ln_s(double x) { return std::log(std::max(x, TINY)); }
inline double lnabs_s(double x) {
  return std::log(std::max(std::fabs(x), TINY));
}
inline double log1p_s(double x) {
  return std::log1p(std::max(x, -1.0 + TINY));
}
inline double sqrt_s(double x) { return std::sqrt(std::max(x, 0.0)); }

// --- real dilogarithm, full range (specfun.li2; Re(Li2) for x > 1) ---

inline double li2_bern(double z) {  // Bernoulli series, z in [-1, 0.5]
  static const double C[] = {
      0.02777777777777777778,    -0.0002777777777777777778,
      4.724111866969009826e-6,   -9.185773074661963551e-8,
      1.897886998897099907e-9,   -4.064761645144225527e-11,
      8.921691020456452555e-13,  -1.993929586072107569e-14,
      4.518980029619918192e-16,  -1.035651761218124701e-17,
      2.395218621026186746e-19,  -5.581785874325009336e-21,
      1.309150755418321286e-22,  -3.087419802426740293e-24,
      7.31597565270220342e-26,   -1.740845657234000741e-27,
      4.15763564461389972e-29,   -9.962148488284622103e-31,
      2.394034424896165301e-32,  -5.768347355367390084e-34};
  double w = -std::log1p(-z);
  double w2 = w * w;
  double s = 0.0;
  for (int k = 19; k >= 0; --k) s = (s + C[k]) * w2;
  return w - w * w * 0.25 + s * w;
}

inline double li2_full(double x) {
  if (x < -1.0) {
    double lx = std::log(-x);
    return -NR_PI2_6 - 0.5 * lx * lx - li2_bern(1.0 / x);
  }
  if (x <= 0.5) return li2_bern(x);
  if (x <= 2.0) {
    if (x == 1.0) return NR_PI2_6;
    return NR_PI2_6 - std::log(x) * std::log(std::fabs(1.0 - x)) -
           li2_bern(1.0 - x);
  }
  double lx = std::log(x);
  return 2.0 * NR_PI2_6 - 0.5 * lx * lx - li2_bern(1.0 / x);
}

// --- complex dilogarithm (specfun.li2c; on the cut: limit from below,
//     Im Li2(x - i0) = -pi ln x, the GSL convention) ---

inline cd li2c_series(cd z) {
  static const double C[] = {
      0.02777777777777777778,    -0.0002777777777777777778,
      4.724111866969009826e-6,   -9.185773074661963551e-8,
      1.897886998897099907e-9,   -4.064761645144225527e-11,
      8.921691020456452555e-13,  -1.993929586072107569e-14,
      4.518980029619918192e-16,  -1.035651761218124701e-17,
      2.395218621026186746e-19,  -5.581785874325009336e-21,
      1.309150755418321286e-22,  -3.087419802426740293e-24,
      7.31597565270220342e-26,   -1.740845657234000741e-27,
      4.15763564461389972e-29,   -9.962148488284622103e-31,
      2.394034424896165301e-32,  -5.768347355367390084e-34};
  cd w = -std::log(1.0 - z);
  cd w2 = w * w;
  cd s = 0.0;
  for (int k = 19; k >= 0; --k) s = (s + C[k]) * w2;
  return w - w * w * 0.25 + s * w;
}

inline cd li2c(cd z) {
  double az = std::abs(z);
  if (az > 1.0) {
    cd zi = 1.0 / z;
    cd val = (zi.real() > 0.5)
                 ? NR_PI2_6 - std::log(zi) * std::log(1.0 - zi) -
                       li2c_series(1.0 - zi)
                 : li2c_series(zi);
    cd mz = (z.imag() == 0.0 && z.real() > 0.0)
                ? cd(-z.real(), 1e-300)  // cut: limit from below
                : -z;
    cd lnm = std::log(mz);
    return -NR_PI2_6 - 0.5 * lnm * lnm - val;
  }
  if (z.real() > 0.5)
    return NR_PI2_6 - std::log(z) * std::log(1.0 - z) - li2c_series(1.0 - z);
  return li2c_series(z);
}

inline cd dilogdiff_c(cd x, cd y) {  // specfun.dilogdiff_cx
  if (std::abs(x) > 1e2 && std::abs(y) > 1e2) {
    auto tail = [](cd z) {
      double sgn = (z.imag() >= 0.0) ? 1.0 : -1.0;
      cd iz = 1.0 / z;
      cd lz = std::log(z);
      cd iz2 = iz * iz;
      return -(iz2 * iz2) / 16.0 - iz2 * iz / 9.0 - iz2 / 4.0 - iz -
             cd(0, 0.5) * (-sgn * 2.0 * NR_PI * lz - cd(0, 1) * lz * lz);
    };
    return tail(x) - tail(y);
  }
  return li2c(x) - li2c(y);
}

// --- real difference functions (aux.hpp:98-166 / specfun.py) ---

inline double dilogdiff(double x, double y) {  // Li2(-x)-Li2(-y), x,y>0
  if (x > 1e2 && y > 1e2) {
    auto t = [](double v) {
      double iv = 1.0 / v, lv = std::log(v);
      return -0.5 * lv * lv + iv - iv * iv / 4.0 + iv * iv * iv / 9.0 -
             (iv * iv) * (iv * iv) / 16.0;
    };
    return t(x) - t(y);
  }
  if (x < 1e-2 && y < 1e-2) {
    auto t = [](double v) {
      return -v + v * v / 4.0 - v * v * v / 9.0 + (v * v) * (v * v) / 16.0;
    };
    return t(x) - t(y);
  }
  return li2_full(-x) - li2_full(-y);
}

inline double dilog1mdiff(double x, double y) {  // Li2(-1-x)-Li2(-1-y)
  constexpr double LN2 = 0.6931471805599453;
  if (x > 1e2 && y > 1e2) {
    auto t = [](double v) {
      double lv = std::log(v), v2 = v * v;
      return -0.5 * lv * lv + (1.0 - lv) / v + (-7.0 + 2.0 * lv) / (4.0 * v2) +
             (19.0 - 3.0 * lv) / (9.0 * v2 * v) +
             (-125.0 + 12.0 * lv) / (48.0 * v2 * v2);
    };
    return t(x) - t(y);
  }
  if (x < 1e-2 && y < 1e-2) {
    auto t = [](double v) {
      double v2 = v * v;
      return -v * LN2 + v2 * (-1.0 + 2.0 * LN2) / 4.0 +
             v2 * v * (5.0 - 8.0 * LN2) / 24.0 +
             v2 * v2 * (-1.0 / 6.0 + LN2 / 4.0);
    };
    return t(x) - t(y);
  }
  return li2_full(-1.0 - x) - li2_full(-1.0 - y);
}

inline double dilog1pdiff(double x, double y) {  // Li2(1+x)-Li2(1+y), x,y<0
  if (-x > 1e2 && -y > 1e2) {
    auto t = [](double v) {
      double lv = std::log(-v), v2 = v * v;
      return (-1.0 - 3.0 * lv) / (9.0 * v2 * v) + (-1.0 - lv) / v -
             0.5 * lv * lv + (1.0 + 2.0 * lv) / (4.0 * v2) +
             (1.0 + 4.0 * lv) / (16.0 * v2 * v2);
    };
    return t(x) - t(y);
  }
  if (-x < 1e-2 && -y < 1e-2) {
    auto t = [](double v) {
      double lv = std::log(-v), v2 = v * v;
      return v * (1.0 - lv) + v2 * (-1.0 + 2.0 * lv) / 4.0 +
             v2 * v * (1.0 - 3.0 * lv) / 9.0 +
             v2 * v2 * (-1.0 + 4.0 * lv) / 16.0;
    };
    return t(std::min(x, -1e-300)) - t(std::min(y, -1e-300));
  }
  return li2_full(1.0 + x) - li2_full(1.0 + y);
}

inline double dilog1over1mdiff(double x, double y) {  // Li2(1/(1-x))-..., x,y<0
  if (-x > 1e2 && -y > 1e2) {
    auto t = [](double v) {
      double v2 = v * v;
      return -25.0 / (48.0 * v2 * v2) - 11.0 / (18.0 * v2 * v) -
             3.0 / (4.0 * v2) - 1.0 / v;
    };
    return t(x) - t(y);
  }
  if (-x < 1e-2 && -y < 1e-2) {
    auto t = [](double v) {
      double lv = std::log(-v), v2 = v * v;
      return v2 * v2 * (-19.0 - 12.0 * lv) / 48.0 +
             v2 * v * (-7.0 - 6.0 * lv) / 18.0 + v2 * (-1.0 - 2.0 * lv) / 4.0 +
             v * (1.0 - lv);
    };
    return t(std::min(x, -1e-300)) - t(std::min(y, -1e-300));
  }
  return li2_full(1.0 / (1.0 - x)) - li2_full(1.0 / (1.0 - y));
}

// --- 3-pt GL helpers (rescue quadratures) ---

inline const double NR_GLX[3] = {-0.7745966692414834, 0.0,
                                 0.7745966692414834};
inline const double NR_GLW[3] = {5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0};

template <class F>
inline double gl3(F f, double a, double b) {
  double h = 0.5 * (b - a), m = 0.5 * (b + a), acc = 0.0;
  for (int q = 0; q < 3; ++q) acc += NR_GLW[q] * f(h * NR_GLX[q] + m);
  return h * acc;
}

template <class F>
inline double gl3_tri(F f, double tp, double tm) {
  // y in [tp, tm], x in [-y, -tp] (nuSIprop.hpp:985-1005)
  double hy = 0.5 * (tm - tp), my = 0.5 * (tm + tp), acc = 0.0;
  for (int qy = 0; qy < 3; ++qy) {
    double y = hy * NR_GLX[qy] + my;
    double ax = -y, bx = -tp;
    double hx = 0.5 * (bx - ax), mx = 0.5 * (bx + ax), in = 0.0;
    for (int qx = 0; qx < 3; ++qx) in += NR_GLW[qx] * f(y, hx * NR_GLX[qx] + mx);
    acc += NR_GLW[qy] * hx * in;
  }
  return hy * acc;
}

template <class F>
inline double gl3_rect(F f, double tp, double tm, double a, double b) {
  double hy = 0.5 * (tm - tp), my = 0.5 * (tm + tp);
  double hx = 0.5 * (b - a), mx = 0.5 * (b + a), acc = 0.0;
  for (int qy = 0; qy < 3; ++qy) {
    double y = hy * NR_GLX[qy] + my;
    double in = 0.0;
    for (int qx = 0; qx < 3; ++qx) in += NR_GLW[qx] * f(y, hx * NR_GLX[qx] + mx);
    acc += NR_GLW[qy] * in;
  }
  return hy * hx * acc;
}

// ===========================================================================
// Gamma channels (mphi^2-scaled; kernels_nr.py:79-214)
// ===========================================================================

inline double gamma_t_u(double sm, double sp, double g) {
  double pref = (g * g) / (16.0 * NR_PI) * (g * g);
  double closed = pref * (2.0 * std::log1p(sp) / sp - 2.0 * std::log1p(sm) / sm +
                          std::log1p(sp) - std::log1p(sm));
  if (closed < 0.0) {
    auto f = [](double z) {
      return (z + 2.0) / (z * (z + 1.0)) - 2.0 / (z * z) * std::log1p(z);
    };
    return pref * gl3(f, sm, sp);
  }
  return closed;
}

inline double gamma_tu(double sm, double sp, double g) {
  double pref = (g * g) / (32.0 * NR_PI * sm * sp) * (g * g);
  double closed = pref * (
      sm * std::log1p(sp) * (2.0 + 2.0 * sp + sp * ln_s(2.0 + sp)) -
      sp * std::log1p(sm) * (2.0 + 2.0 * sm + sm * ln_s(2.0 + sm)) +
      sm * sp * (dilog1mdiff(sp, sm) + dilogdiff(sp, sm)));
  if (closed < 0.0) {
    auto f = [](double z) {
      return 1.0 / z - 2.0 * (1.0 + z) / (z * z * (2.0 + z)) * std::log1p(z);
    };
    return (g * g) / (16.0 * NR_PI) * (g * g) * gl3(f, sm, sp);
  }
  return closed;
}

inline double gamma_st(double sm, double sp, double g, double gr) {
  cd den(gr, 2.0);
  cd z1p = cd(0.0, 1.0 + sp) / den;
  cd z1m = cd(0.0, 1.0 + sm) / den;
  cd d1;
  if (sp < 1e-5) {  // Taylor (nuSIprop.hpp:853-861)
    cd cl = std::log(cd(gr, 1.0) / den);
    cd a_m = cd(0.0, -0.5) / cd(gr, 1.0) - cl * 0.5;
    cd a_p = (cd(0.0, 1.0) / cd(gr, 1.0) + cl) * 0.5;
    d1 = a_m * (sm * sm) + cl * sm - cl * sp + a_p * (sp * sp);
  } else {
    d1 = dilogdiff_c(z1p, z1m);
  }
  double gr2 = gr * gr;
  double l1psp = std::log1p(std::max(sp, 0.0));
  double l1psm = std::log1p(std::max(sm, 0.0));
  double pref = -(g * g) / (32.0 * NR_PI * (1.0 + gr2)) * (g * g);
  return pref * (
      2.0 * d1.real() - 2.0 * gr * d1.imag() -
      2.0 * gr * std::arg(1.0 - z1p) * l1psp +
      2.0 * gr * std::arg(1.0 - z1m) * l1psm +
      std::log1p(4.0 / gr2) * (l1psm - l1psp) +
      std::log1p((sp - 1.0) * (sp - 1.0) / gr2) * l1psp -
      std::log1p((sm - 1.0) * (sm - 1.0) / gr2) * l1psm +
      (1.0 + gr2) * (std::log1p((sm - 1.0) * (sm - 1.0) / gr2) -
                     std::log1p((sp - 1.0) * (sp - 1.0) / gr2)) +
      2.0 * dilogdiff(sp, sm));
}

inline double gamma_nr(double sm, double sp, double g, double gr,
                       bool majorana) {
  if (sp < COORD_FLOOR) return 0.0;
  sm = std::max(sm, COORD_FLOOR);
  sp = std::max(sp, COORD_FLOOR);
  double tot = 2.0 * gamma_t_u(sm, sp, g);  // nu and nubar targets
  tot += (majorana ? 1.0 : 0.5) * gamma_tu(sm, sp, g);
  double st = gamma_st(sm, sp, g, gr);
  tot += majorana ? 2.0 * st : st;
  return tot;
}

// ===========================================================================
// alphaTilde channels (mphi^4-scaled; kernels_nr.py:282-580)
// ===========================================================================

inline double at_quad(double tm, double tp, double g, int kind) {
  // kind: 0 maj_t, 1 dirac_t, 2 dirac_u, 3 maj_tu
  auto F = [kind](double y, double x) {
    if (std::fabs(x) < TINY) x = TINY;
    double u = -x - y;
    switch (kind) {
      case 0: {
        double a = (y / x) * (y / x) / ((y - 1.0) * (y - 1.0));
        double b = (u / x) * (u / x) / ((u - 1.0) * (u - 1.0));
        return a + b;
      }
      case 3:
        return 2.0 * y * u / (x * x) / ((y - 1.0) * (u - 1.0));
      default:
        return (y / x) * (y / x) / ((y - 1.0) * (y - 1.0));
    }
  };
  double pref;
  switch (kind) {
    case 0: pref = (g * g) / (16.0 * NR_PI) * (g * g); break;
    case 1: pref = 1.5 * (g * g) / (32.0 * NR_PI) * (g * g); break;
    case 2: pref = 0.5 * (g * g) / (32.0 * NR_PI) * (g * g); break;
    default: pref = (g * g) / (16.0 * NR_PI) * (g * g); break;
  }
  return pref * gl3_tri(F, tp, tm);
}

inline double at_t_base_dirac(double tm, double tp) {
  return (tm - 2.0) * (tm - tp) -
         (tm - 1.0) * (tp - 2.0) * (std::log1p(-tm) - std::log1p(-tp));
}

inline double alphatilde_t(double tm, double tp, double g, bool majorana) {
  double closed;
  if (majorana) {
    double t1 = ((g * g) / (16.0 * NR_PI * (tm - 1.0) * tp) * (g * g)) *
                at_t_base_dirac(tm, tp);
    double omt = 1.0 + tm;
    double t2 = ((g * g) / (16.0 * NR_PI * omt * omt * tp) * (g * g)) *
                (omt * (2.0 + tm) * (tm - tp) +
                 (-2.0 * omt * omt + tp + 2.0 * tm * tp) * log1p_s(tm - tp) -
                 tm * tm * tp * ln_s(tm / tp));
    closed = t1 + t2;
    if (closed < 0.0) return at_quad(tm, tp, g, 0);
    return closed;
  }
  closed = (1.5 * (g * g) / (32.0 * NR_PI * (tm - 1.0) * tp) * (g * g)) *
           at_t_base_dirac(tm, tp);
  if (closed < 0.0) return at_quad(tm, tp, g, 1);
  return closed;
}

inline double alphatilde_u(double tm, double tp, double g, double at_t_maj,
                           bool majorana) {
  if (majorana) return at_t_maj;
  double closed = (0.5 * (g * g) / (32.0 * NR_PI * (tm - 1.0) * tp) * (g * g)) *
                  at_t_base_dirac(tm, tp);
  if (closed < 0.0) return at_quad(tm, tp, g, 2);
  return closed;
}

inline double alphatilde_tu(double tm, double tp, double g, bool majorana) {
  if (!majorana) return 0.0;
  constexpr double LN2 = 0.6931471805599453;
  double delta = tp / tm;
  double ltp = ln_s(-tp);
  double d2 = delta * delta, d3 = d2 * delta, d4 = d3 * delta;
  double tp2 = tp * tp, tp3 = tp2 * tp, tp4 = tp3 * tp;
  double dilog_combi;
  if (-tp < 1e-2 && -tm < 1e-2) {
    dilog_combi =
        -(((delta - 1.0) * tp * ln_s(-2.0 * tp)) / delta) -
        ((delta - 1.0) * tp2 *
         (-2.0 + delta + delta * LN2 + ln_s(-2.0 / tp) - delta * ltp)) /
            (2.0 * d2) +
        (tp3 * (8.0 - 30.0 * delta + 21.0 * d2 + d3 - 8.0 * d3 * LN2 +
                std::log(256.0) + 8.0 * ltp - 8.0 * d3 * ltp)) /
            (24.0 * d3) +
        (tp4 * (-32.0 + 56.0 * delta - 51.0 * d2 + 30.0 * d3 - 3.0 * d4 +
                std::log(4096.0) - d4 * std::log(4096.0) - 12.0 * ltp +
                12.0 * d4 * ltp)) /
            (48.0 * d4);
  } else if (-tp > 1e2 && -tm > 1e2) {
    double ldd = ln_s((delta - 1.0) / delta);
    dilog_combi =
        (-2.0 * (delta - 1.0) * ldd) / tp -
        (2.0 * (1.0 + ln_s(-(delta / ((delta - 1.0) * tp))))) / tp2 +
        (-6.0 + 4.0 * delta + d2 - 2.0 * d3 - 8.0 * ldd + 8.0 * delta * ldd +
         2.0 * d3 * ldd - 2.0 * d4 * ldd - 6.0 * ltp + 6.0 * delta * ltp) /
            (3.0 * (delta - 1.0) * tp3) +
        (8.0 - 12.0 * delta + 3.0 * d2 + 12.0 * ldd - 24.0 * delta * ldd +
         12.0 * d2 * ldd + 12.0 * ltp - 24.0 * delta * ltp + 12.0 * d2 * ltp) /
            (3.0 * (delta - 1.0) * (delta - 1.0) * tp4);
  } else {
    dilog_combi = li2_full(1.0 + 1.0 / (tp - 2.0)) -
                  li2_full((tm - 1.0) / (tp - 2.0)) +
                  li2_full(1.0 + (1.0 + tm - tp) / tp) -
                  li2_full(1.0 + 1.0 / tp);
  }
  double omt = 1.0 + tm;
  double l1mtm = std::log1p(-tm), l1mtp = std::log1p(-tp);
  double l1dt = log1p_s(tm - tp);
  double atanh1 = std::atanh(1.0 / (1.0 - tp));
  double atanh2 = std::atanh((tm - tp) / (tm + tp - 2.0));
  double closed = ((g * g) / (32.0 * NR_PI * omt * tp) * (g * g)) * (
      2.0 * (2.0 * omt * (tm - tp) - 2.0 * omt * tp * atanh1 * atanh2 +
             tm * tp * (-l1mtm + l1mtp) + omt * (l1mtm - l1mtp - l1dt) +
             tp * (-l1mtm + l1mtp + l1dt) - tm * tp * ln_s(tm / tp)) +
      omt * tp * ((-l1mtm * l1mtm + l1mtp * l1mtp) / 2.0 +
                  dilog1over1mdiff(tp, tm)) -
      omt * tp * (dilog1pdiff(tm, tp) + dilog_combi));
  if (closed < 0.0) return at_quad(tm, tp, g, 3);
  return closed;
}

inline double alphatilde_st(double tm, double tp, double g, double gr,
                            bool majorana) {
  cd den(gr, 2.0);
  cd den_t(2.0 + tm, -gr);
  cd z1 = cd(0.0, -(tm - 1.0)) / den;
  cd z2(1.0 / (1.0 + tm), 0.0);
  cd z3 = 1.0 / den_t;
  cd z4 = cd(1.0 + tm - tp, 0.0) / den_t;
  cd z5 = cd(0.0, -(tp - 1.0)) / den;
  cd z6(1.0 - tp / (1.0 + tm), 0.0);
  cd z7(1.0 - tm, 0.0);
  cd z8(1.0 - tp, 0.0);

  cd d_z7z8, d_z5z1, d_z2z6, d_z4z3;
  if (-tp < 1e-5) {  // Taylor (nuSIprop.hpp:1151-1168)
    double delta = tp / tm;
    cd cl12 = std::log(1.0 - cd(0.0, 1.0) / den);
    cd clg = std::log(cd(gr, 1.0) / den);
    cd ltmc = std::log(cd(tm, 0.0));
    cd ltpc = std::log(cd(tp == 0.0 ? 1.0 : tp, 0.0));
    d_z7z8 = (ltmc - 1.0) * tm + (ltmc * 2.0 - 1.0) * (tm * tm / 4.0) -
             ((ltpc - 1.0) * tp + (ltpc * 2.0 - 1.0) * (tp * tp / 4.0));
    d_z5z1 = cl12 * (tp - tm) +
             ((cd(-(1.0 + cl12).imag(), (1.0 + cl12).real()) + cl12 * gr) *
              (tp * tp - tm * tm)) /
                 (cd(gr, 1.0) * 2.0);
    cd cld = std::log(cd(delta, 0.0));
    double dd2 = delta * delta, dd3 = dd2 * delta;
    d_z2z6 =
        (cd(-1.0 + delta, 0.0) - cld + ltpc - ltpc * delta) * (tp / delta) +
        (cd(-1.0 + dd2, 0.0) + cld * 2.0 - ltpc * 2.0 + ltpc * (4.0 * delta) -
         ltpc * (2.0 * dd2)) *
            (tp * tp / (4.0 * dd2)) +
        (cd(7.0 - 9.0 * delta + 2.0 * dd3, 0.0) - cld * 6.0 + ltpc * 6.0 -
         ltpc * (18.0 * delta) + ltpc * (18.0 * dd2) - ltpc * (6.0 * dd3)) *
            (tp * tp * tp / (18.0 * dd3));
    cd i_term = cd(1.0 + delta, 0.0) / cd(gr, 1.0) - 2.0 / den;
    d_z4z3 = clg * ((delta - 1.0) * tp / delta) +
             (cd(-i_term.imag(), i_term.real()) + clg * (delta - 1.0)) *
                 ((delta - 1.0) * tp * tp / (2.0 * dd2));
  } else {
    d_z7z8 = dilogdiff_c(z7, z8);
    d_z5z1 = dilogdiff_c(z5, z1);
    d_z2z6 = dilogdiff_c(z2, z6);
    d_z4z3 = dilogdiff_c(z4, z3);
  }

  double gr2 = gr * gr;
  double l1mtm = std::log1p(-tm), l1mtp = std::log1p(-tp);
  double l1dt = log1p_s(tm - tp);
  double pref = (g * g) / (32.0 * NR_PI * (1.0 + gr2)) * (g * g);
  double arg_m = std::atan2(gr, -1.0 - tm);
  double arg_p = std::atan2(gr, -1.0 - tp);
  double arg_rm = std::arg(cd(gr, 1.0 + tm) / den);
  double arg_rp = std::arg(cd(gr, 1.0 + tp) / den);

  if (majorana) {
    return pref * (
        2.0 * NR_PI * arg_m - 2.0 * NR_PI * arg_p +
        2.0 * gr * (d_z5z1.imag() + d_z2z6.imag() + d_z4z3.imag()) -
        2.0 * (d_z5z1.real() + d_z2z6.real() + d_z4z3.real() + d_z7z8.real()) -
        arg_rm * (2.0 * NR_PI + 2.0 * gr * l1mtm) +
        arg_rp * (2.0 * NR_PI + 2.0 * gr * l1mtp) +
        (arg_m - arg_p) * (4.0 * gr * tm + 2.0 * gr * l1mtm) +
        2.0 * gr *
            (std::atan2(0.0, 1.0 + tm) - std::atan2(-gr, 2.0 + tm) +
             std::atan2(-gr, 1.0 + tp)) *
            l1dt +
        ln_s(4.0 + gr2) * (l1mtp - l1mtm) +
        ln_s(gr2 + (2.0 + tm) * (2.0 + tm)) * l1dt -
        2.0 * l1mtm * ln_s(-tp) - 2.0 * gr * NR_PI * (ln_s(tp * tp) + l1dt) +
        2.0 * gr * NR_PI * ln_s(tp * tp) + 4.0 * tm * ln_s(tm / tp) +
        (-l1mtp + l1mtm - l1dt) *
            (std::log1p((1.0 + tp) * (1.0 + tp) / gr2) + 2.0 * ln_s(gr)) -
        l1dt * log1p_s(tm * tm + 2.0 * tm) +
        2.0 * (gr2 + tm) * (std::log1p((1.0 + tp) * (1.0 + tp) / gr2) -
                            std::log1p((1.0 + tm) * (1.0 + tm) / gr2)) +
        2.0 * (ln_s(-tp) * (l1mtp + l1dt) +
               (std::log1p((1.0 + tp) * (1.0 + tp) / gr2) -
                std::log1p((1.0 + tm) * (1.0 + tm) / gr2))));
  }
  return pref * (
      gr * d_z5z1.imag() - 2.0 * (d_z5z1 + d_z7z8).real() +
      2.0 * arg_rm * (-NR_PI - gr * l1mtm) +
      2.0 * arg_m * (NR_PI + gr * tm + gr * l1mtm) -
      2.0 * arg_p * (NR_PI + gr * tm + gr * l1mtm) +
      2.0 * arg_rp * (NR_PI + gr * l1mtp) - 2.0 * l1mtm * ln_s(-tp) +
      2.0 * tm * ln_s(tm / tp) + 2.0 * l1mtp * ln_s(-tp) +
      (l1mtp - l1mtm) * (ln_s(4.0 + gr2) - 2.0 * ln_s(gr) -
                         std::log1p((1.0 + tp) * (1.0 + tp) / gr2)) +
      (1.0 + tm + gr2) * (std::log1p((1.0 + tp) * (1.0 + tp) / gr2) -
                          std::log1p((1.0 + tm) * (1.0 + tm) / gr2)));
}

inline double alphatilde_nr(double tm, double tp, double g, double gr,
                            bool majorana) {
  if (-tp < COORD_FLOOR) return 0.0;
  tm = std::min(tm, -COORD_FLOOR);
  tp = std::min(tp, -COORD_FLOOR);
  double at_t = alphatilde_t(tm, tp, g, majorana);
  double tot = at_t + alphatilde_u(tm, tp, g, at_t, majorana);
  tot += alphatilde_tu(tm, tp, g, majorana);
  double st = alphatilde_st(tm, tp, g, gr, majorana);
  tot += majorana ? 2.0 * st : st;
  return tot;
}

// ===========================================================================
// alpha channels (mphi^4-scaled; kernels_nr.py:589-946)
// ===========================================================================

inline double a_quad(double tm, double tp, double smp, double spp, double g,
                     int kind) {  // 0 maj_t, 1 dirac_t, 2 dirac_u
  auto F = [kind](double y, double x) {
    if (x < TINY) x = TINY;
    double u = -x - y;
    if (kind == 0) {
      return (y / x) * (y / x) / ((y - 1.0) * (y - 1.0)) +
             (u / x) * (u / x) / ((u - 1.0) * (u - 1.0));
    }
    return (y / x) * (y / x) / ((y - 1.0) * (y - 1.0));
  };
  double pref = (kind == 0)   ? (g * g) / (16.0 * NR_PI) * (g * g)
                : (kind == 1) ? 1.5 * (g * g) / (32.0 * NR_PI) * (g * g)
                              : 0.5 * (g * g) / (32.0 * NR_PI) * (g * g);
  return pref * gl3_rect(F, tp, tm, smp, spp);
}

inline double alpha_t(double tm, double tp, double smp, double spp, double g,
                      bool majorana) {
  smp = std::max(smp, TINY);
  spp = std::max(spp, TINY);
  if (majorana) {
    double omtm = 1.0 + tm, omtp = 1.0 + tp;
    double lr_m = ln_s(((1.0 + smp + tm) * (tp - 1.0)) /
                       ((tm - 1.0) * (1.0 + smp + tp)));
    double lr_p = ln_s(((1.0 + spp + tm) * (tp - 1.0)) /
                       ((tm - 1.0) * (1.0 + spp + tp)));
    double bracket =
        smp * spp * (tp - tm) * ln_s(smp) + smp * spp * (tm - tp) * ln_s(spp) -
        smp * spp * log1p_s(smp + tm) - smp * spp * tp * log1p_s(smp + tm) +
        smp * spp * log1p_s(spp + tm) + smp * spp * tp * log1p_s(spp + tm) -
        spp * lr_m - spp * tm * lr_m - spp * tp * lr_m - spp * tm * tp * lr_m +
        smp * spp * log1p_s(smp + tp) + smp * spp * tm * log1p_s(smp + tp) +
        smp * lr_p + smp * tm * lr_p + smp * tp * lr_p + smp * tm * tp * lr_p -
        smp * spp * log1p_s(spp + tp) - smp * spp * tm * log1p_s(spp + tp);
    double closed = ((g * g) / (smp * spp * 16.0 * NR_PI) * (g * g)) * (
        -((smp - spp) * (3.0 + 2.0 * tm * (tp - 1.0) - 2.0 * tp) * (tm - tp)) /
            ((tm - 1.0) * (tp - 1.0)) +
        2.0 * bracket / (omtm * omtp) -
        ((smp * spp *
          ln_s((smp * (1.0 + spp + tm)) / (spp * (1.0 + smp + tm)))) /
             (omtm * omtm) +
         (((smp - spp) * (tm - tp) * omtp) / omtm -
          smp * spp *
              ln_s((smp * (1.0 + spp + tp)) / (spp * (1.0 + smp + tp)))) /
             (omtp * omtp)));
    if (closed < 0.0) return a_quad(tm, tp, smp, spp, g, 0);
    return closed;
  }
  double closed = (1.5 * (g * g) /
                   (32.0 * NR_PI * smp * spp * (tm - 1.0) * (tp - 1.0)) *
                   (g * g)) *
                  (smp - spp) *
                  (-((tm - tp) * (2.0 + tm * (tp - 1.0) - tp)) -
                   2.0 * (tm - 1.0) * (tp - 1.0) *
                       (std::log1p(-tm) - std::log1p(-tp)));
  if (closed < 0.0) return a_quad(tm, tp, smp, spp, g, 1);
  return closed;
}

inline double alpha_u(double tm, double tp, double smp, double spp, double g,
                      double a_t_maj, bool majorana) {
  if (majorana) return a_t_maj;
  smp = std::max(smp, TINY);
  spp = std::max(spp, TINY);
  double closed = (0.5 * (g * g) /
                   (32.0 * NR_PI * smp * spp * (tm - 1.0) * (tp - 1.0)) *
                   (g * g)) *
                  (smp - spp) *
                  (-((tm - tp) * (2.0 + tm * (tp - 1.0) - tp)) -
                   2.0 * (tm - 1.0) * (tp - 1.0) *
                       (std::log1p(-tm) - std::log1p(-tp)));
  if (closed < 0.0) return a_quad(tm, tp, smp, spp, g, 2);
  return closed;
}

inline double alpha_tu(double tm, double tp, double smp, double spp, double g,
                       bool majorana) {
  // NOTE: the reference's rescue assigns to a shadowing local, so the
  // closed form is ALWAYS returned (kernels_nr.alpha_tu note).
  if (!majorana) return 0.0;
  smp = std::max(smp, TINY);
  spp = std::max(spp, TINY);
  auto fctr = [&](double t) {
    if (t < -1.0) {
      return li2_full((1.0 + smp + t) / smp) - li2_full((1.0 + spp + t) / spp);
    }
    double den_m = 1.0 + smp + t;
    if (std::fabs(den_m) < TINY) den_m = TINY;
    double den_p = 1.0 + spp + t;
    if (std::fabs(den_p) < TINY) den_p = TINY;
    return -li2_full(smp / den_m) + li2_full(spp / den_p) -
           0.5 * (lnabs_s(den_m / smp) * lnabs_s(den_m / smp) -
                  lnabs_s(den_p / spp) * lnabs_s(den_p / spp));
  };
  double FCTR_tp = fctr(tp);
  double FCTR_tm = -fctr(tm);
  double l1p_abs_tp = (tp > -1.0) ? log1p_s(tp) : ln_s(-1.0 - tp);
  double l1p_abs_tm = (tm > -1.0) ? log1p_s(tm) : ln_s(-1.0 - tm);
  double omtm = 1.0 + tm, omtp = 1.0 + tp;
  double l1mtm = std::log1p(-tm), l1mtp = std::log1p(-tp);
  double lsm = ln_s(smp), lsp = ln_s(spp);
  double l_sm_tm = log1p_s(smp + tm), l_sp_tm = log1p_s(spp + tm);
  double l_sm_tp = log1p_s(smp + tp), l_sp_tp = log1p_s(spp + tp);
  double ss = smp * spp;
  return ((g * g) / (32.0 * NR_PI * ss * omtm * omtp) * (g * g)) * (
      -4.0 * (smp - spp) * omtm * (tm - tp) * omtp +
      2.0 * ss * tp * (lsm - lsp - l_sm_tm + l_sp_tm) +
      2.0 * spp * omtm * omtp * (l1mtm - l_sm_tm - l1mtp + l_sm_tp) -
      2.0 * smp * omtm * omtp * (l1mtm - l_sp_tm - l1mtp + l_sp_tp) +
      2.0 * ss * (-l_sm_tm + l_sp_tm + l_sm_tp - l_sp_tp) +
      ss * omtm * omtp *
          (ln_s((2.0 + smp) / smp) * (lsp + l_sm_tp) -
           ln_s((2.0 + spp) / spp) * (lsm + l_sp_tp) +
           l1mtp * (lsm - lsp - l_sm_tp + l_sp_tp)) +
      ss * omtm * omtp *
          ((lsp + l_sm_tm) * (ln_s(smp / (2.0 + smp)) + l1mtm - l1p_abs_tm) +
           (lsm + l_sp_tm) * (ln_s((2.0 + spp) / spp) - l1mtm + l1p_abs_tm)) +
      ss * (lsp - lsm + l_sm_tp - l_sp_tp) *
          (2.0 * tm + omtm * omtp * l1p_abs_tp) +
      ss * omtm * omtp *
          (li2_full((1.0 + smp + tm) / (2.0 + smp)) -
           li2_full((1.0 + spp + tm) / (2.0 + spp)) -
           li2_full((1.0 + smp + tp) / (2.0 + smp)) +
           li2_full((1.0 + spp + tp) / (2.0 + spp))) +
      ss * omtm * omtp * (FCTR_tp + FCTR_tm));
}

inline double alpha_st(double tm, double tp, double smp, double spp, double g,
                       double gr, bool majorana) {
  smp = std::max(smp, TINY);
  spp = std::max(spp, TINY);
  double gr2 = gr * gr;
  double pref = (g * g) / (32.0 * NR_PI * (1.0 + gr2)) * (g * g);
  if (!majorana) {
    return pref * (
        2.0 * gr * std::atan2(gr, smp - 1.0) -
        2.0 * gr * std::atan2(gr, spp - 1.0) + 2.0 * ln_s(smp) -
        2.0 * ln_s(spp) + std::log1p((spp - 1.0) * (spp - 1.0) / gr2) -
        std::log1p((smp - 1.0) * (smp - 1.0) / gr2)) *
        (tm - tp + std::log1p(-tm) - std::log1p(-tp));
  }
  cd dm(2.0 + tm, -gr);
  cd dp(2.0 + tp, -gr);
  auto li2_gsl_real = [](double x) {  // Im = -pi ln x for x >= 1
    return cd(li2_full(x), x >= 1.0 ? -NR_PI * ln_s(std::max(x, 1.0)) : 0.0);
  };
  cd z1 = li2_gsl_real((1.0 + smp + tm) / (1.0 + tm));
  cd z3 = li2_gsl_real((1.0 + spp + tm) / (1.0 + tm));
  cd z5 = li2_gsl_real((1.0 + smp + tp) / (1.0 + tp));
  cd z7 = li2_gsl_real((1.0 + spp + tp) / (1.0 + tp));
  cd z2 = li2c(cd(1.0 + smp + tm, 0.0) / dm);
  cd z4 = li2c(cd(1.0 + spp + tm, 0.0) / dm);
  cd z6 = li2c(cd(1.0 + smp + tp, 0.0) / dp);
  cd z8 = li2c(cd(1.0 + spp + tp, 0.0) / dp);
  double im_combo = z1.imag() - z2.imag() - z3.imag() + z4.imag() -
                    z5.imag() + z6.imag() + z7.imag() - z8.imag();
  double re_combo = z1.real() - z2.real() - z3.real() + z4.real() -
                    z5.real() + z6.real() + z7.real() - z8.real();
  double arg_inv_tm = (1.0 + tm > 0.0) ? NR_PI : 0.0;
  double arg_inv_tp = (1.0 + tp > 0.0) ? NR_PI : 0.0;
  double arg_sm_tm = std::arg(-(cd(smp - 1.0, gr) / dm));
  double arg_sp_tm = std::arg(-(cd(spp - 1.0, gr) / dm));
  double arg_sm_tp = std::arg(-(cd(smp - 1.0, gr) / dp));
  double arg_sp_tp = std::arg(-(cd(spp - 1.0, gr) / dp));
  double arg_sm = std::atan2(gr, smp - 1.0);
  double arg_sp = std::atan2(gr, spp - 1.0);
  double l_sm_tm = log1p_s(smp + tm), l_sp_tm = log1p_s(spp + tm);
  double l_sm_tp = log1p_s(smp + tp), l_sp_tp = log1p_s(spp + tp);
  double labs_tm = lnabs_s(1.0 + tm), labs_tp = lnabs_s(1.0 + tp);
  return pref * (
      2.0 * gr * im_combo - 2.0 * re_combo +
      2.0 * gr * (arg_inv_tm - arg_sm_tm) * l_sm_tm -
      2.0 * gr * (arg_inv_tm - arg_sp_tm) * l_sp_tm +
      2.0 * gr * (arg_inv_tp - arg_sp_tp) * l_sp_tp -
      2.0 * gr * (arg_inv_tp - arg_sm_tp) * l_sm_tp +
      2.0 * (gr * arg_sm - gr * arg_sp +
             std::log1p((spp - 1.0) * (spp - 1.0) / gr2) / 2.0 -
             std::log1p((smp - 1.0) * (smp - 1.0) / gr2) / 2.0 + ln_s(smp) -
             ln_s(spp)) *
          (2.0 * (tm - tp) + (std::log1p(-tm) - std::log1p(-tp))) +
      l_sm_tm * (std::log1p((smp - 1.0) * (smp - 1.0) / gr2) -
                 std::log1p((2.0 + tm) * (2.0 + tm) / gr2) -
                 2.0 * (ln_s(smp) - labs_tm)) -
      l_sp_tm * (std::log1p((spp - 1.0) * (spp - 1.0) / gr2) -
                 std::log1p((2.0 + tm) * (2.0 + tm) / gr2) -
                 2.0 * (ln_s(spp) - labs_tm)) -
      l_sm_tp * (std::log1p((smp - 1.0) * (smp - 1.0) / gr2) -
                 std::log1p((2.0 + tp) * (2.0 + tp) / gr2) -
                 2.0 * (ln_s(smp) - labs_tp)) +
      l_sp_tp * (std::log1p((spp - 1.0) * (spp - 1.0) / gr2) -
                 std::log1p((2.0 + tp) * (2.0 + tp) / gr2) -
                 2.0 * (ln_s(spp) - labs_tp)));
}

inline double alpha_nr(double tm, double tp, double smp, double spp, double g,
                       double gr, bool majorana) {
  if (-tp < COORD_FLOOR || spp < COORD_FLOOR) return 0.0;
  tm = std::min(tm, -COORD_FLOOR);
  tp = std::min(tp, -COORD_FLOOR);
  smp = std::max(smp, COORD_FLOOR);
  spp = std::max(spp, COORD_FLOOR);
  double a_t = alpha_t(tm, tp, smp, spp, g, majorana);
  double tot = a_t + alpha_u(tm, tp, smp, spp, g, a_t, majorana);
  tot += alpha_tu(tm, tp, smp, spp, g, majorana);
  double st = alpha_st(tm, tp, smp, spp, g, gr, majorana);
  tot += majorana ? 2.0 * st : st;
  return tot;
}

}  // namespace nr
}  // namespace nusi
