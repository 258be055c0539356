"""CRS transforms and per-EPSG bounds, pure math.

Port copy of ``mosaic_tpu.core.geometry.crs`` (pure numpy), with its
own copies of ``epsg_params.npz`` and ``epsg_bounds.npz`` beside it.

Reference counterpart: MosaicGeometry.transformCRSXY
(core/geometry/MosaicGeometry.scala:136-160, via proj4j) and
core/crs/CRSBoundsProvider.scala:20 (resource-file EPSG bounds for
ST_HasValidCoordinates).

Implemented projections (closed-form, vectorizable, no proj dependency):

- EPSG:4326  WGS84 lon/lat degrees
- EPSG:3857  Web/Spherical Mercator metres
- EPSG:326xx / 327xx  WGS84 UTM zones north/south (Karney-series
  transverse Mercator, ~1e-9 deg round-trip accuracy)
- EPSG:27700 British National Grid (same TM core on the Airy 1830
  ellipsoid + 7-parameter Helmert datum shift WGS84↔OSGB36,
  ~1-2 m absolute like every Helmert-based OSTN-free implementation;
  round-trips to mm)

Routing always goes through 4326: from_epsg → 4326 → to_epsg.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

__all__ = ["transform_xy", "crs_bounds", "has_valid_coordinates"]

_R_MAJOR = 6378137.0                       # WGS84 a
_WGS84 = (6378137.0, 1 / 298.257223563)
_AIRY = (6377563.396, 1 / 299.3249646)

# Helmert WGS84 -> OSGB36 (tx, ty, tz [m], rx, ry, rz [arcsec], s [ppm])
_HELMERT_OSGB = (-446.448, 125.157, -542.060,
                 -0.1502, -0.2470, -0.8421, 20.4894)


# ------------------------------------------------------------- mercator

def _to_webmercator(lon, lat):
    x = np.radians(lon) * _R_MAJOR
    lat = np.clip(lat, -89.9999, 89.9999)
    y = _R_MAJOR * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2))
    return x, y


def _from_webmercator(x, y):
    lon = np.degrees(x / _R_MAJOR)
    lat = np.degrees(2 * np.arctan(np.exp(y / _R_MAJOR)) - np.pi / 2)
    return lon, lat


# ------------------------------------------------- transverse mercator

def _tm_forward(lon, lat, a, f, lon0, lat0, k0, fe, fn):
    """Snyder-series transverse Mercator (ellipsoidal), forward."""
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    lam = np.radians(lon) - math.radians(lon0)
    phi = np.radians(lat)
    n_ = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    t = np.tan(phi) ** 2
    c = ep2 * np.cos(phi) ** 2
    A = lam * np.cos(phi)
    m = _meridian_arc(phi, a, e2)
    m0 = _meridian_arc(np.asarray(math.radians(lat0)), a, e2)
    x = fe + k0 * n_ * (A + (1 - t + c) * A ** 3 / 6 +
                        (5 - 18 * t + t * t + 72 * c - 58 * ep2) *
                        A ** 5 / 120)
    y = fn + k0 * (m - m0 + n_ * np.tan(phi) *
                   (A * A / 2 + (5 - t + 9 * c + 4 * c * c) *
                    A ** 4 / 24 +
                    (61 - 58 * t + t * t + 600 * c - 330 * ep2) *
                    A ** 6 / 720))
    return x, y


def _tm_inverse(x, y, a, f, lon0, lat0, k0, fe, fn):
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    m0 = _meridian_arc(np.asarray(math.radians(lat0)), a, e2)
    phi1 = _footpoint_lat(m0 + (y - fn) / k0, a, e2)
    n1 = a / np.sqrt(1 - e2 * np.sin(phi1) ** 2)
    r1 = a * (1 - e2) / (1 - e2 * np.sin(phi1) ** 2) ** 1.5
    t1 = np.tan(phi1) ** 2
    c1 = ep2 * np.cos(phi1) ** 2
    d = (x - fe) / (n1 * k0)
    phi = phi1 - (n1 * np.tan(phi1) / r1) * (
        d * d / 2 -
        (5 + 3 * t1 + 10 * c1 - 4 * c1 * c1 - 9 * ep2) * d ** 4 / 24 +
        (61 + 90 * t1 + 298 * c1 + 45 * t1 * t1 - 252 * ep2 -
         3 * c1 * c1) * d ** 6 / 720)
    lam = (d - (1 + 2 * t1 + c1) * d ** 3 / 6 +
           (5 - 2 * c1 + 28 * t1 - 3 * c1 * c1 + 8 * ep2 +
            24 * t1 * t1) * d ** 5 / 120) / np.cos(phi1)
    return np.degrees(lam) + lon0, np.degrees(phi)


def _footpoint_lat(M, a, e2):
    """Footpoint latitude from a meridian-arc distance (rectifying
    series, EPSG GN7-2) — shared by the TM and Cassini inverses."""
    e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
    mu = M / (a * (1 - e2 / 4 - 3 * e2 * e2 / 64 - 5 * e2 ** 3 / 256))
    return (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu) +
            (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu) +
            (151 * e1 ** 3 / 96) * np.sin(6 * mu) +
            (1097 * e1 ** 4 / 512) * np.sin(8 * mu))


def _meridian_arc(phi, a, e2):
    return a * ((1 - e2 / 4 - 3 * e2 * e2 / 64 - 5 * e2 ** 3 / 256) * phi
                - (3 * e2 / 8 + 3 * e2 * e2 / 32 +
                   45 * e2 ** 3 / 1024) * np.sin(2 * phi)
                + (15 * e2 * e2 / 256 +
                   45 * e2 ** 3 / 1024) * np.sin(4 * phi)
                - (35 * e2 ** 3 / 3072) * np.sin(6 * phi))


# -------------------------------------------------------- datum shifts

def _geodetic_to_ecef(lon, lat, a, f, h=0.0):
    e2 = f * (2 - f)
    phi = np.radians(lat)
    lam = np.radians(lon)
    n = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    x = (n + h) * np.cos(phi) * np.cos(lam)
    y = (n + h) * np.cos(phi) * np.sin(lam)
    z = (n * (1 - e2) + h) * np.sin(phi)
    return x, y, z


def _ecef_to_geodetic(x, y, z, a, f):
    e2 = f * (2 - f)
    b = a * (1 - f)
    p = np.hypot(x, y)
    lam = np.arctan2(y, x)
    phi = np.arctan2(z, p * (1 - e2))
    for _ in range(6):
        n = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
        h = p / np.cos(phi) - n
        phi = np.arctan2(z, p * (1 - e2 * n / (n + h)))
    return np.degrees(lam), np.degrees(phi)


def _helmert(x, y, z, params, inverse=False):
    tx, ty, tz, rx, ry, rz, s = params
    sgn = -1.0 if inverse else 1.0
    rx, ry, rz = (sgn * math.radians(v / 3600) for v in (rx, ry, rz))
    m = 1 + sgn * s * 1e-6
    tx, ty, tz = sgn * tx, sgn * ty, sgn * tz
    x2 = tx + m * (x - rz * y + ry * z)
    y2 = ty + m * (rz * x + y - rx * z)
    z2 = tz + m * (-ry * x + rx * y + z)
    return x2, y2, z2


def _wgs84_to_osgb_lonlat(lon, lat):
    x, y, z = _geodetic_to_ecef(lon, lat, *_WGS84)
    x, y, z = _helmert(x, y, z, _HELMERT_OSGB)
    return _ecef_to_geodetic(x, y, z, *_AIRY)


def _osgb_to_wgs84_lonlat(lon, lat):
    x, y, z = _geodetic_to_ecef(lon, lat, *_AIRY)
    x, y, z = _helmert(x, y, z, _HELMERT_OSGB, inverse=True)
    return _ecef_to_geodetic(x, y, z, *_WGS84)


# ------------------------------------------- generic projection engine
# (round-5) Table-driven forward/inverse for EVERY EPSG projected CRS
# whose method is implemented — 5,053 codes extracted from the PROJ
# EPSG registry into epsg_params.npz (tools/build_epsg_params.py).
# Formulas follow EPSG Guidance Note 7-2.  Reference counterpart:
# MosaicGeometry.transformCRSXY via proj4j (MosaicGeometry.scala:
# 136-160) and RasterProject.scala:45 via OSR — same registry, same
# math, no native proj dependency here.

_PROJ_TABLE = None


def _proj_table():
    global _PROJ_TABLE
    if _PROJ_TABLE is None:
        import os
        z = np.load(os.path.join(os.path.dirname(__file__),
                                 "epsg_params.npz"))
        _PROJ_TABLE = {k: z[k] for k in z.files}
    return _PROJ_TABLE


def _proj_entry(epsg: int):
    """Packed parameter record for an EPSG projected CRS, or None."""
    t = _proj_table()
    i = int(np.searchsorted(t["epsg"], epsg))
    if i >= len(t["epsg"]) or int(t["epsg"][i]) != epsg:
        return None
    p = t["params"][i]
    return dict(method=int(t["method"][i]),
                lat0=p[0], lon0=p[1], sp1=p[2], sp2=p[3],
                k0=(1.0 if np.isnan(p[4]) else float(p[4])),
                fe=(0.0 if np.isnan(p[5]) else float(p[5])),
                fn=(0.0 if np.isnan(p[6]) else float(p[6])),
                axis_m=float(t["axis_m"][i]),
                a=float(t["ell_a"][i]), f=1.0 / float(t["ell_rf"][i]),
                pm=float(t["pm_deg"][i]),
                helmert=tuple(t["helmert"][i]),
                helmert_acc=float(t["helmert_acc"][i]))


def _ts(phi, e):
    """EPSG isometric-latitude function t(φ)."""
    return np.tan(np.pi / 4 - phi / 2) / (
        (1 - e * np.sin(phi)) / (1 + e * np.sin(phi))) ** (e / 2)


def _msc(phi, e2):
    return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)


def _phi_from_ts(ts, e, iters=8):
    """Invert t(φ) by fixed-point iteration (EPSG GN7-2)."""
    phi = np.pi / 2 - 2 * np.arctan(ts)
    for _ in range(iters):
        con = e * np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(
            ts * ((1 - con) / (1 + con)) ** (e / 2))
    return phi


def _qa(phi, e, e2):
    """Authalic q(φ) (Albers / LAEA)."""
    s = np.sin(phi)
    return (1 - e2) * (s / (1 - e2 * s * s) -
                       (1 / (2 * e)) * np.log((1 - e * s) /
                                              (1 + e * s)))


def _phi_from_q(q, e, e2, iters=10):
    phi = np.arcsin(np.clip(q / 2, -1, 1))
    for _ in range(iters):
        s = np.sin(phi)
        num = (q / (1 - e2) - s / (1 - e2 * s * s) +
               np.log((1 - e * s) / (1 + e * s)) / (2 * e))
        phi = phi + (1 - e2 * s * s) ** 2 / (2 * np.cos(phi)) * num
    return phi


def _lcc_consts(p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    if p["method"] == 9801:
        phi0 = math.radians(p["lat0"])
        n = math.sin(phi0)
        m0 = _msc(np.asarray(phi0), e2)
        t0 = _ts(np.asarray(phi0), e)
        F = float(m0) / (n * float(t0) ** n) * p["k0"]
        r0 = p["a"] * F * float(t0) ** n
    else:
        phi1 = math.radians(p["sp1"])
        phi2 = math.radians(p["sp2"])
        phiF = math.radians(p["lat0"])
        m1 = float(_msc(np.asarray(phi1), e2))
        m2 = float(_msc(np.asarray(phi2), e2))
        t1 = float(_ts(np.asarray(phi1), e))
        t2 = float(_ts(np.asarray(phi2), e))
        tF = float(_ts(np.asarray(phiF), e))
        n = (math.log(m1) - math.log(m2)) / \
            (math.log(t1) - math.log(t2)) if phi1 != phi2 else \
            math.sin(phi1)
        F = m1 / (n * t1 ** n)
        r0 = p["a"] * F * tF ** n
    return e, n, F, r0


def _lcc_forward(lon, lat, p):
    e, n, F, r0 = _lcc_consts(p)
    t = _ts(np.radians(lat), e)
    r = p["a"] * F * t ** n
    th = n * np.radians(lon - p["lon0"])
    return p["fe"] + r * np.sin(th), p["fn"] + r0 - r * np.cos(th)


def _lcc_inverse(x, y, p):
    e, n, F, r0 = _lcc_consts(p)
    dx = x - p["fe"]
    dy = r0 - (y - p["fn"])
    sgn = 1.0 if n >= 0 else -1.0
    r = sgn * np.hypot(dx, dy)
    t = (r / (p["a"] * F)) ** (1.0 / n)
    th = np.arctan2(sgn * dx, sgn * dy)
    lon = np.degrees(th / n) + p["lon0"]
    lat = np.degrees(_phi_from_ts(t, e))
    return lon, lat


def _albers_consts(p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    phi0 = math.radians(p["lat0"])
    phi1 = math.radians(p["sp1"])
    phi2 = math.radians(p["sp2"])
    m1 = float(_msc(np.asarray(phi1), e2))
    m2 = float(_msc(np.asarray(phi2), e2))
    q0 = float(_qa(np.asarray(phi0), e, e2))
    q1 = float(_qa(np.asarray(phi1), e, e2))
    q2 = float(_qa(np.asarray(phi2), e, e2))
    n = (m1 * m1 - m2 * m2) / (q2 - q1) if phi1 != phi2 else \
        math.sin(phi1)
    C = m1 * m1 + n * q1
    rho0 = p["a"] * math.sqrt(max(C - n * q0, 0.0)) / n
    return e, e2, n, C, rho0


def _albers_forward(lon, lat, p):
    e, e2, n, C, rho0 = _albers_consts(p)
    q = _qa(np.radians(lat), e, e2)
    rho = p["a"] * np.sqrt(np.maximum(C - n * q, 0.0)) / n
    th = n * np.radians(lon - p["lon0"])
    return p["fe"] + rho * np.sin(th), p["fn"] + rho0 - rho * np.cos(th)


def _albers_inverse(x, y, p):
    e, e2, n, C, rho0 = _albers_consts(p)
    dx = x - p["fe"]
    dy = rho0 - (y - p["fn"])
    sgn = 1.0 if n >= 0 else -1.0
    rho = sgn * np.hypot(dx, dy)
    q = (C - (rho * n / p["a"]) ** 2) / n
    th = np.arctan2(sgn * dx, sgn * dy)
    lon = np.degrees(th / n) + p["lon0"]
    lat = np.degrees(_phi_from_q(q, e, e2))
    return lon, lat


def _merc_forward(lon, lat, p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    k0 = p["k0"] if p["method"] == 9804 else \
        float(_msc(np.asarray(math.radians(p["sp1"])), e2))
    lat = np.clip(lat, -89.99, 89.99)
    x = p["fe"] + p["a"] * k0 * np.radians(lon - p["lon0"])
    y = p["fn"] - p["a"] * k0 * np.log(_ts(np.radians(lat), e))
    return x, y


def _merc_inverse(x, y, p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    k0 = p["k0"] if p["method"] == 9804 else \
        float(_msc(np.asarray(math.radians(p["sp1"])), e2))
    t = np.exp((p["fn"] - y) / (p["a"] * k0))
    lon = np.degrees((x - p["fe"]) / (p["a"] * k0)) + p["lon0"]
    lat = np.degrees(_phi_from_ts(t, e))
    return lon, lat


def _ps_consts(p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    if p["method"] == 9810:
        north = p["lat0"] >= 0
        k0 = p["k0"]
        scale = 2 * p["a"] * k0 / math.sqrt(
            (1 + e) ** (1 + e) * (1 - e) ** (1 - e))
    else:                                   # 9829: std parallel given
        north = p["sp1"] >= 0
        phiF = math.radians(abs(p["sp1"]))
        mF = float(_msc(np.asarray(phiF), e2))
        tF = float(_ts(np.asarray(phiF), e))
        scale = p["a"] * mF / tF
    return e, north, scale


def _ps_forward(lon, lat, p):
    e, north, scale = _ps_consts(p)
    if north:
        t = _ts(np.radians(lat), e)
        lam = np.radians(lon - p["lon0"])
        rho = scale * t
        return p["fe"] + rho * np.sin(lam), p["fn"] - rho * np.cos(lam)
    t = _ts(np.radians(-lat), e)
    lam = np.radians(lon - p["lon0"])
    rho = scale * t
    return p["fe"] + rho * np.sin(lam), p["fn"] + rho * np.cos(lam)


def _ps_inverse(x, y, p):
    e, north, scale = _ps_consts(p)
    dx = x - p["fe"]
    dy = y - p["fn"]
    rho = np.hypot(dx, dy)
    t = rho / scale
    if north:
        lam = np.arctan2(dx, -dy)
        lat = np.degrees(_phi_from_ts(t, e))
    else:
        lam = np.arctan2(dx, dy)
        lat = -np.degrees(_phi_from_ts(t, e))
    return np.degrees(lam) + p["lon0"], lat


def _laea_consts(p):
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    phi0 = math.radians(p["lat0"])
    qp = float(_qa(np.asarray(math.pi / 2), e, e2))
    q0 = float(_qa(np.asarray(phi0), e, e2))
    beta0 = math.asin(min(max(q0 / qp, -1.0), 1.0))
    Rq = p["a"] * math.sqrt(qp / 2)
    m0 = float(_msc(np.asarray(phi0), e2))
    D = p["a"] * m0 / (Rq * math.cos(beta0))
    return e, e2, qp, beta0, Rq, D


def _laea_forward(lon, lat, p):
    e, e2, qp, beta0, Rq, D = _laea_consts(p)
    q = _qa(np.radians(lat), e, e2)
    beta = np.arcsin(np.clip(q / qp, -1, 1))
    lam = np.radians(lon - p["lon0"])
    B = Rq * np.sqrt(2 / (1 + math.sin(beta0) * np.sin(beta) +
                          math.cos(beta0) * np.cos(beta) *
                          np.cos(lam)))
    x = p["fe"] + B * D * np.cos(beta) * np.sin(lam)
    y = p["fn"] + (B / D) * (math.cos(beta0) * np.sin(beta) -
                             math.sin(beta0) * np.cos(beta) *
                             np.cos(lam))
    return x, y


def _laea_inverse(x, y, p):
    e, e2, qp, beta0, Rq, D = _laea_consts(p)
    xp = (x - p["fe"]) / D
    yp = (y - p["fn"]) * D
    rho = np.hypot(xp, yp)
    C = 2 * np.arcsin(np.clip(rho / (2 * Rq), -1, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        q = qp * (np.cos(C) * math.sin(beta0) +
                  np.where(rho == 0, 0.0,
                           yp * np.sin(C) * math.cos(beta0) /
                           np.where(rho == 0, 1.0, rho)))
        lam = np.arctan2(xp * np.sin(C),
                         rho * math.cos(beta0) * np.cos(C) -
                         yp * math.sin(beta0) * np.sin(C))
    lat = np.degrees(_phi_from_q(q, e, e2))
    return np.degrees(lam) + p["lon0"], lat


def _sterea_consts(p):
    """Oblique (double) stereographic — EPSG 9809 (e.g. RD/28992)."""
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    phi0 = math.radians(p["lat0"])
    rho0 = p["a"] * (1 - e2) / (1 - e2 * math.sin(phi0) ** 2) ** 1.5
    nu0 = p["a"] / math.sqrt(1 - e2 * math.sin(phi0) ** 2)
    R = math.sqrt(rho0 * nu0)
    n = math.sqrt(1 + e2 * math.cos(phi0) ** 4 / (1 - e2))
    S1 = (1 + math.sin(phi0)) / (1 - math.sin(phi0))
    S2 = (1 - e * math.sin(phi0)) / (1 + e * math.sin(phi0))
    w1 = (S1 * S2 ** e) ** n
    sin_chi0 = (w1 - 1) / (w1 + 1)
    c = (n + math.sin(phi0)) * (1 - sin_chi0) / \
        ((n - math.sin(phi0)) * (1 + sin_chi0))
    w2 = c * w1
    chi0 = math.asin((w2 - 1) / (w2 + 1))
    return e, n, c, R, chi0


def _sterea_forward(lon, lat, p):
    e, n, c, R, chi0 = _sterea_consts(p)
    phi = np.radians(lat)
    lam0 = math.radians(p["lon0"])
    Lam = n * (np.radians(lon) - lam0) + lam0
    Sa = (1 + np.sin(phi)) / (1 - np.sin(phi))
    Sb = (1 - e * np.sin(phi)) / (1 + e * np.sin(phi))
    w = c * (Sa * Sb ** e) ** n
    chi = np.arcsin((w - 1) / (w + 1))
    B = 1 + np.sin(chi) * math.sin(chi0) + \
        np.cos(chi) * math.cos(chi0) * np.cos(Lam - lam0)
    k0 = p["k0"]
    x = p["fe"] + 2 * R * k0 * np.cos(chi) * np.sin(Lam - lam0) / B
    y = p["fn"] + 2 * R * k0 * (np.sin(chi) * math.cos(chi0) -
                                np.cos(chi) * math.sin(chi0) *
                                np.cos(Lam - lam0)) / B
    return x, y


def _sterea_inverse(x, y, p):
    e, n, c, R, chi0 = _sterea_consts(p)
    k0 = p["k0"]
    lam0 = math.radians(p["lon0"])
    xp = x - p["fe"]
    yp = y - p["fn"]
    g = 2 * R * k0 * math.tan(math.pi / 4 - chi0 / 2)
    h = 4 * R * k0 * math.tan(chi0) + g
    i = np.arctan2(xp, h + yp)
    j = np.arctan2(xp, g - yp) - i
    chi = chi0 + 2 * np.arctan2(yp - xp * np.tan(j / 2), 2 * R * k0)
    Lam = j + 2 * i + lam0
    lon = np.degrees((Lam - lam0) / n) + p["lon0"]
    # invert the conformal latitude: Newton on the isometric latitude
    psi = 0.5 * np.log((1 + np.sin(chi)) /
                       (c * (1 - np.sin(chi)))) / n
    phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
    for _ in range(6):
        s = e * np.sin(phi)
        psi_i = np.log(np.tan(phi / 2 + np.pi / 4) *
                       ((1 - s) / (1 + s)) ** (e / 2))
        phi = phi - (psi_i - psi) * np.cos(phi) * \
            (1 - s * s) / (1 - e * e)
    return lon, np.degrees(phi)


def _cassini_forward(lon, lat, p):
    e2 = p["f"] * (2 - p["f"])
    ep2 = e2 / (1 - e2)
    phi = np.radians(lat)
    lam = np.radians(lon - p["lon0"])
    A = lam * np.cos(phi)
    T = np.tan(phi) ** 2
    C = ep2 * np.cos(phi) ** 2
    nu = p["a"] / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    M = _meridian_arc(phi, p["a"], e2)
    M0 = _meridian_arc(np.asarray(math.radians(p["lat0"])), p["a"], e2)
    x = p["fe"] + nu * (A - T * A ** 3 / 6 -
                        (8 - T + 8 * C) * T * A ** 5 / 120)
    y = p["fn"] + M - M0 + nu * np.tan(phi) * (
        A * A / 2 + (5 - T + 6 * C) * A ** 4 / 24)
    return x, y


def _cassini_inverse(x, y, p):
    e2 = p["f"] * (2 - p["f"])
    ep2 = e2 / (1 - e2)
    a = p["a"]
    M0 = _meridian_arc(np.asarray(math.radians(p["lat0"])), a, e2)
    phi1 = _footpoint_lat(M0 + (y - p["fn"]), a, e2)
    T1 = np.tan(phi1) ** 2
    nu1 = a / np.sqrt(1 - e2 * np.sin(phi1) ** 2)
    rho1 = a * (1 - e2) / (1 - e2 * np.sin(phi1) ** 2) ** 1.5
    D = (x - p["fe"]) / nu1
    phi = phi1 - (nu1 * np.tan(phi1) / rho1) * (
        D * D / 2 - (1 + 3 * T1) * D ** 4 / 24)
    lam = (D - T1 * D ** 3 / 3 +
           (1 + 3 * T1) * T1 * D ** 5 / 15) / np.cos(phi1)
    return np.degrees(lam) + p["lon0"], np.degrees(phi)


def _hom_consts(p):
    """Hotine Oblique Mercator shared constants (EPSG 9812/9815).
    slots: lat0=latc, lon0=lonc, sp1=azimuth, sp2=gamma_c, k0=kc."""
    e2 = p["f"] * (2 - p["f"])
    e = math.sqrt(e2)
    phic = math.radians(p["lat0"])
    alc = math.radians(p["sp1"])
    kc = p["k0"]
    B = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
    A = p["a"] * B * kc * math.sqrt(1 - e2) / \
        (1 - e2 * math.sin(phic) ** 2)
    t0 = float(_ts(np.asarray(phic), e))
    D = B * math.sqrt(1 - e2) / (
        math.cos(phic) * math.sqrt(1 - e2 * math.sin(phic) ** 2))
    D2 = max(D * D, 1.0)
    F = D + math.copysign(math.sqrt(D2 - 1.0), phic)
    H = F * t0 ** B
    G = (F - 1.0 / F) / 2.0
    g0 = math.asin(min(max(math.sin(alc) / D, -1.0), 1.0))
    lam0 = math.radians(p["lon0"]) - math.asin(
        min(max(G * math.tan(g0), -1.0), 1.0)) / B
    # variant-B offset of the projection centre along the u axis
    uc = (A / B) * math.atan2(math.sqrt(D2 - 1.0), math.cos(alc))
    uc = math.copysign(uc, phic)
    return e, B, A, H, g0, lam0, uc


def _hom_forward(lon, lat, p):
    e, B, A, H, g0, lam0, uc = _hom_consts(p)
    gc = math.radians(p["sp2"])
    t = _ts(np.radians(lat), e)
    Q = H / t ** B
    S = (Q - 1.0 / Q) / 2.0
    T = (Q + 1.0 / Q) / 2.0
    dl = B * (np.radians(lon) - lam0)
    # keep the skew longitude in (-pi, pi]
    dl = (dl + np.pi) % (2 * np.pi) - np.pi
    V = np.sin(dl)
    U = (-V * math.cos(g0) + S * math.sin(g0)) / T
    v = A * np.log((1 - U) / (1 + U)) / (2 * B)
    u = A * np.arctan2(S * math.cos(g0) + V * math.sin(g0),
                       np.cos(dl)) / B
    if p["method"] == 9815:
        u = u - uc
    x = v * math.cos(gc) + u * math.sin(gc) + p["fe"]
    y = u * math.cos(gc) - v * math.sin(gc) + p["fn"]
    return x, y


def _hom_inverse(x, y, p):
    e, B, A, H, g0, lam0, uc = _hom_consts(p)
    gc = math.radians(p["sp2"])
    xp = x - p["fe"]
    yp = y - p["fn"]
    v = xp * math.cos(gc) - yp * math.sin(gc)
    u = yp * math.cos(gc) + xp * math.sin(gc)
    if p["method"] == 9815:
        u = u + uc
    Q = np.exp(-B * v / A)
    S = (Q - 1.0 / Q) / 2.0
    T = (Q + 1.0 / Q) / 2.0
    V = np.sin(B * u / A)
    U = (V * math.cos(g0) + S * math.sin(g0)) / T
    t = (H / np.sqrt((1 + U) / (1 - U))) ** (1.0 / B)
    lat = np.degrees(_phi_from_ts(t, e))
    lam = lam0 - np.arctan2(S * math.cos(g0) - V * math.sin(g0),
                            np.cos(B * u / A)) / B
    return np.degrees(lam), lat


def _generic_forward(lon, lat, p):
    """(lon, lat on the CRS's own datum/PM, degrees) -> native units."""
    m = p["method"]
    if m in (9807, 9808):
        x, y = _tm_forward(lon, lat, p["a"], p["f"], p["lon0"],
                           p["lat0"], p["k0"], 0.0, 0.0)
        if m == 9808:                        # westing/southing axes
            x, y = -x, -y
        x, y = x + p["fe"], y + p["fn"]
    elif m in (9801, 9802):
        x, y = _lcc_forward(lon, lat, p)
    elif m == 9826:                      # LCC 1SP, westing axis
        xe, y = _lcc_forward(lon, lat, dict(p, method=9801, fe=0.0))
        x = p["fe"] - xe
    elif m == 9806:
        x, y = _cassini_forward(lon, lat, p)
    elif m in (9812, 9815):
        x, y = _hom_forward(lon, lat, p)
    elif m == 9822:
        x, y = _albers_forward(lon, lat, p)
    elif m in (9804, 9805):
        x, y = _merc_forward(lon, lat, p)
    elif m in (9810, 9829):
        x, y = _ps_forward(lon, lat, p)
    elif m == 9820:
        x, y = _laea_forward(lon, lat, p)
    elif m == 9809:
        x, y = _sterea_forward(lon, lat, p)
    else:
        raise ValueError(f"unimplemented projection method {m}")
    return x / p["axis_m"], y / p["axis_m"]


def _generic_inverse(x, y, p):
    m = p["method"]
    x = np.asarray(x, np.float64) * p["axis_m"]
    y = np.asarray(y, np.float64) * p["axis_m"]
    if m in (9807, 9808):
        xi, yi = x - p["fe"], y - p["fn"]
        if m == 9808:
            xi, yi = -xi, -yi
        return _tm_inverse(xi, yi, p["a"], p["f"], p["lon0"],
                           p["lat0"], p["k0"], 0.0, 0.0)
    if m in (9801, 9802):
        return _lcc_inverse(x, y, p)
    if m == 9826:
        return _lcc_inverse(p["fe"] - x, y,
                            dict(p, method=9801, fe=0.0))
    if m == 9806:
        return _cassini_inverse(x, y, p)
    if m in (9812, 9815):
        return _hom_inverse(x, y, p)
    if m == 9822:
        return _albers_inverse(x, y, p)
    if m in (9804, 9805):
        return _merc_inverse(x, y, p)
    if m in (9810, 9829):
        return _ps_inverse(x, y, p)
    if m == 9820:
        return _laea_inverse(x, y, p)
    if m == 9809:
        return _sterea_inverse(x, y, p)
    raise ValueError(f"unimplemented projection method {m}")


_DATUM_WARNED = set()


def _check_datum_registry(p, epsg: int) -> None:
    """Surface registry-less datum shifts instead of silently applying
    the identity.

    605 of the 5,053 table codes carry no Helmert parameters
    (``helmert_acc`` is NaN, helmert all zeros): for those the datum
    leg of the transform silently degrades to the identity, which can
    be off by up to hundreds of meters.  Count every occurrence in the
    metrics registry, warn once per EPSG code, and raise when the
    ``mosaic.crs.strict.datum`` conf flag is set.  Codes whose
    helmert_acc is 0.0 are genuinely WGS84-equivalent and pass
    silently."""
    import math
    acc = p.get("helmert_acc", 0.0)
    if not (isinstance(acc, float) and math.isnan(acc)):
        return
    from ...obs import metrics
    metrics.count("crs/identity_datum_shift")
    metrics.count(f"crs/identity_datum_shift/{epsg}")
    from ...config import default_config
    if default_config().crs_strict_datum:
        raise ValueError(
            f"EPSG {epsg}: the registry has no Helmert datum "
            "parameters for this code (helmert_acc is NaN) — the "
            "datum shift would silently be the identity (potentially "
            "hundreds of meters off).  Unset mosaic.crs.strict.datum "
            "to accept the approximation.")
    if epsg not in _DATUM_WARNED:
        _DATUM_WARNED.add(epsg)
        import warnings
        warnings.warn(
            f"EPSG {epsg}: no Helmert datum parameters in the "
            "registry — applying an identity datum shift (set "
            "mosaic.crs.strict.datum=true to raise instead)",
            RuntimeWarning, stacklevel=3)


def _datum_to_wgs84(lon, lat, p):
    lon = lon + p["pm"]                      # CRS PM -> Greenwich
    h = p["helmert"]
    if all(v == 0.0 for v in h):
        return lon, lat
    x, y, z = _geodetic_to_ecef(lon, lat, p["a"], p["f"])
    x, y, z = _helmert(x, y, z, h)
    return _ecef_to_geodetic(x, y, z, *_WGS84)


def _wgs84_to_datum(lon, lat, p):
    h = p["helmert"]
    if not all(v == 0.0 for v in h):
        x, y, z = _geodetic_to_ecef(lon, lat, *_WGS84)
        x, y, z = _helmert(x, y, z, h, inverse=True)
        lon, lat = _ecef_to_geodetic(x, y, z, p["a"], p["f"])
    return lon - p["pm"], lat


def epsg_from_name(name: str):
    """EPSG code for a CRS name (EPSG or ESRI spelling), or None.

    Matching is on normalized names (uppercase, runs of non-alnum
    collapsed to '_'), against both the primary EPSG names and the
    registry's alias table (which includes the ESRI spellings found in
    .prj files without an AUTHORITY node)."""
    import re
    key = re.sub(r"[^A-Z0-9]+", "_", name.upper()).strip("_")
    t = _proj_table()
    hit = np.nonzero(t["name"] == key)[0]
    if len(hit):
        return int(t["epsg"][hit[0]])
    if "alias_name" in t:
        hit = np.nonzero(t["alias_name"] == key)[0]
        if len(hit):
            return int(t["alias_code"][hit[0]])
    return None


# ------------------------------------------------------------- routing

_OSGB_TM = dict(a=_AIRY[0], f=_AIRY[1], lon0=-2.0, lat0=49.0,
                k0=0.9996012717, fe=400_000.0, fn=-100_000.0)


def _utm_params(epsg: int) -> dict:
    zone = epsg % 100
    north = (epsg // 100) % 10 == 6      # 326xx north / 327xx south
    if not 1 <= zone <= 60 or (epsg // 100) not in (326, 327):
        raise ValueError(f"unsupported UTM EPSG {epsg}")
    return dict(a=_WGS84[0], f=_WGS84[1], lon0=zone * 6 - 183, lat0=0.0,
                k0=0.9996, fe=500_000.0,
                fn=0.0 if north else 10_000_000.0)


def _is_utm(epsg: int) -> bool:
    return epsg // 100 in (326, 327) and 1 <= epsg % 100 <= 60


def _to_4326(xy: np.ndarray, epsg: int) -> np.ndarray:
    x, y = xy[:, 0], xy[:, 1]
    if epsg == 4326:
        return xy
    if epsg == 3857:
        lon, lat = _from_webmercator(x, y)
    elif epsg == 27700:
        lon, lat = _tm_inverse(x, y, **_OSGB_TM)
        lon, lat = _osgb_to_wgs84_lonlat(lon, lat)
    elif _is_utm(epsg):
        lon, lat = _tm_inverse(x, y, **_utm_params(epsg))
    else:
        p = _proj_entry(epsg)
        if p is None:
            raise ValueError(
                f"unsupported source EPSG {epsg} (analytic: 4326, "
                "3857, 27700, UTM 326xx/327xx; table-driven: 5,053 "
                "projected codes in epsg_params.npz)")
        _check_datum_registry(p, epsg)
        lon, lat = _generic_inverse(x, y, p)
        lon, lat = _datum_to_wgs84(lon, lat, p)
    return np.stack([lon, lat], -1)


def _from_4326(ll: np.ndarray, epsg: int) -> np.ndarray:
    lon, lat = ll[:, 0], ll[:, 1]
    if epsg == 4326:
        return ll
    if epsg == 3857:
        x, y = _to_webmercator(lon, lat)
    elif epsg == 27700:
        lon2, lat2 = _wgs84_to_osgb_lonlat(lon, lat)
        x, y = _tm_forward(lon2, lat2, **_OSGB_TM)
    elif _is_utm(epsg):
        x, y = _tm_forward(lon, lat, **_utm_params(epsg))
    else:
        p = _proj_entry(epsg)
        if p is None:
            raise ValueError(
                f"unsupported target EPSG {epsg} (analytic: 4326, "
                "3857, 27700, UTM 326xx/327xx; table-driven: 5,053 "
                "projected codes in epsg_params.npz)")
        _check_datum_registry(p, epsg)
        lon2, lat2 = _wgs84_to_datum(lon, lat, p)
        x, y = _generic_forward(lon2, lat2, p)
    return np.stack([x, y], -1)


def transform_xy(xy: np.ndarray, from_epsg: int,
                 to_epsg: int) -> np.ndarray:
    """[N, 2] coordinate transform routed through WGS84."""
    xy = np.asarray(xy, np.float64)
    if from_epsg == to_epsg:
        return xy.copy()
    return _from_4326(_to_4326(xy, from_epsg), to_epsg)


# ------------------------------------------------- bounds provider
# (reference: core/crs/CRSBoundsProvider.scala — resource file of
# reprojected + lat/lon bounds per EPSG, from spatialreference.org)

_BOUNDS_4326: Dict[int, Tuple[float, float, float, float]] = {
    4326: (-180.0, -90.0, 180.0, 90.0),
    3857: (-180.0, -85.06, 180.0, 85.06),
    27700: (-8.82, 49.79, 1.92, 60.94),
}

_EPSG_TABLE = None


def _epsg_table():
    """Lazy-loaded per-EPSG bounds resource (epsg_bounds.npz): 3,258
    EPSG codes with lat/lon + native-unit bounds, sourced from the
    published spatialreference.org extents — the same resource list
    the reference ships (core/crs/CRSBoundsProvider.scala:20,
    src/main/resources/CRSBounds.csv).  Stored compressed; arrays are
    (epsg sorted i32, geo [N, 4], proj [N, 4])."""
    global _EPSG_TABLE
    if _EPSG_TABLE is None:
        import os
        path = os.path.join(os.path.dirname(__file__),
                            "epsg_bounds.npz")
        z = np.load(path)
        _EPSG_TABLE = (z["epsg"], z["geo"], z["proj"])
    return _EPSG_TABLE


def crs_bounds(epsg: int, reprojected: bool = True
               ) -> Tuple[float, float, float, float]:
    """(xmin, ymin, xmax, ymax) valid domain of an EPSG, either in its
    own units (reprojected=True) or in lon/lat.

    Lookup order: analytic bounds for the CRSs with full transform
    support (exact), then the per-EPSG resource table (any of 3,258
    codes — round-4: previously only the analytic handful resolved, so
    st_hasvalidcoordinates rejected most real-world CRSs)."""
    if _is_utm(epsg):
        zone = epsg % 100
        ll = (zone * 6 - 186.0, -80.0 if epsg // 100 == 327 else 0.0,
              zone * 6 - 180.0, 84.0 if epsg // 100 == 326 else 0.0)
        if epsg // 100 == 326:
            ll = (ll[0], 0.0, ll[2], 84.0)
        else:
            ll = (ll[0], -80.0, ll[2], 0.0)
    elif epsg in _BOUNDS_4326:
        ll = _BOUNDS_4326[epsg]
    else:
        codes, geo, proj = _epsg_table()
        i = int(np.searchsorted(codes, epsg))
        if i >= len(codes) or codes[i] != epsg:
            raise ValueError(f"no bounds registered for EPSG {epsg}")
        return tuple(proj[i] if reprojected else geo[i])
    if not reprojected or epsg == 4326:
        return ll
    corners = np.array([[ll[0], ll[1]], [ll[2], ll[1]],
                        [ll[2], ll[3]], [ll[0], ll[3]],
                        [(ll[0] + ll[2]) / 2, ll[1]],
                        [(ll[0] + ll[2]) / 2, ll[3]]])
    p = _from_4326(corners, epsg)
    return (float(p[:, 0].min()), float(p[:, 1].min()),
            float(p[:, 0].max()), float(p[:, 1].max()))


def has_valid_coordinates(xy: np.ndarray, epsg: int,
                          which: str = "bounds") -> np.ndarray:
    """[N] bool — every vertex inside the CRS bounds (reference:
    ST_HasValidCoordinates; which in {bounds, reprojected_bounds})."""
    b = crs_bounds(epsg, reprojected=(which == "reprojected_bounds"))
    return ((xy[:, 0] >= b[0]) & (xy[:, 0] <= b[2]) &
            (xy[:, 1] >= b[1]) & (xy[:, 1] <= b[3]))
