"""Adaptive geodistance — behavioral port of the reference's default
GEODIST algorithm (sphinxexpr.cpp:5605-5746 GeodistAdaptiveDeg/Rad):
LUT-backed fast cos/sin/asin(sqrt) with float32 rounding at every step,
flat-ellipsoid model under 13 degrees of longitude difference, haversine
beyond. Matching the tables bit-for-bit is what makes recorded golden
weights/distances reproducible.
"""
from __future__ import annotations

import math

import numpy as np

_TABLE_COS = 1024
_TABLE_ASIN = 512
_TABLE_K = 1024

_PI = math.pi
_TO_RADF = np.float32(_PI / 180.0)
_TO_RADF2 = np.float32(_PI / 360.0)
_TO_DEGF = np.float32(180.0 / _PI)

_g_cos = np.array([math.cos(2 * _PI * i / _TABLE_COS)
                   for i in range(_TABLE_COS + 1)], np.float32)
_g_asin = np.array([math.asin(math.sqrt(i / _TABLE_ASIN))
                    for i in range(_TABLE_ASIN + 1)], np.float32)
_g_k = np.zeros((_TABLE_K + 1, 2), np.float32)
for _i in range(_TABLE_K + 1):
    _x = _PI * _i / _TABLE_K - _PI * 0.5
    _g_k[_i][0] = (111132.09 - 566.05 * math.cos(2 * _x)
                   + 1.20 * math.cos(4 * _x)) ** 2
    _g_k[_i][1] = (111415.13 * math.cos(_x) - 94.55 * math.cos(3 * _x)
                   + 0.12 * math.cos(5 * _x)) ** 2

_f32 = np.float32


def _deg_diff(f: np.float32) -> np.float32:
    f = _f32(abs(float(f)))
    while f > 360:
        f = _f32(f - _f32(360))
    if f > 180:
        f = _f32(_f32(360) - f)
    return f


def _fast_cos(x: np.float32) -> np.float32:
    y = _f32(abs(float(x)) * _TABLE_COS / _PI / 2)
    i = int(y)
    y = _f32(y - i)
    i &= _TABLE_COS - 1
    return _f32(_g_cos[i] + _f32(_g_cos[i + 1] - _g_cos[i]) * y)


def _fast_sin(x: np.float32) -> np.float32:
    y = _f32(abs(float(x)) * _TABLE_COS / _PI / 2)
    i = int(y)
    y = _f32(y - i)
    i = (i - _TABLE_COS // 4) & (_TABLE_COS - 1)   # cos(x-pi/2)=sin(x)
    return _f32(_g_cos[i] + _f32(_g_cos[i + 1] - _g_cos[i]) * y)


def _fast_asin_sqrt(x: float) -> np.float32:
    if x < 0.122:
        y = _f32(math.sqrt(x))
        return _f32(y + x * y * _f32(0.166666666666666)
                    + x * x * y * _f32(0.075)
                    + x * x * x * y * _f32(0.044642857142857))
    if x < 0.948:
        x = _f32(x * _TABLE_ASIN)
        i = int(x)
        return _f32(_g_asin[i] + _f32(_g_asin[i + 1] - _g_asin[i])
                    * _f32(x - i))
    return _f32(math.asin(math.sqrt(x)))


def geodist_adaptive_deg(lat1: float, lon1: float,
                         lat2: float, lon2: float) -> float:
    lat1, lon1 = _f32(lat1), _f32(lon1)
    lat2, lon2 = _f32(lat2), _f32(lon2)
    dlat = _deg_diff(_f32(lat1 - lat2))
    dlon = _deg_diff(_f32(lon1 - lon2))
    if dlon < 13:
        # flat ellipsoid model, k coeffs interpolated at the midpoint
        # (GeodistAdaptiveDeg, sphinxexpr.cpp:5727-5732) — every float
        # multiply/add rounds through float32 exactly as the C code does,
        # and the fraction uses the MASKED index (m - i after i &= K-1)
        m = _f32(_f32(_f32(_f32(lat1 + lat2) + _f32(180.0)) * _f32(_TABLE_K))
                 / _f32(360.0))
        i = int(m) & (_TABLE_K - 1)
        mi = _f32(m - _f32(i))
        kk1 = _f32(_g_k[i][0]
                   + _f32(_f32(_g_k[i + 1][0] - _g_k[i][0]) * mi))
        kk2 = _f32(_g_k[i][1]
                   + _f32(_f32(_g_k[i + 1][1] - _g_k[i][1]) * mi))
        s = _f32(_f32(_f32(kk1 * dlat) * dlat)
                 + _f32(_f32(kk2 * dlon) * dlon))
        return float(_f32(math.sqrt(float(s))))
    d = _f32(2 * 6371000)
    s1 = _fast_sin(_f32(dlat * _TO_RADF2))
    s2 = _fast_sin(_f32(dlon * _TO_RADF2))
    c1 = _fast_cos(_f32(lat1 * _TO_RADF))
    c2 = _fast_cos(_f32(lat2 * _TO_RADF))
    a = _f32(_f32(s1 * s1) + _f32(_f32(c1 * c2) * _f32(s2 * s2)))
    return float(_f32(d * _fast_asin_sqrt(float(a))))


def geodist_adaptive_rad(lat1: float, lon1: float,
                         lat2: float, lon2: float) -> float:
    return geodist_adaptive_deg(float(_f32(lat1) * _TO_DEGF),
                                float(_f32(lon1) * _TO_DEGF),
                                float(_f32(lat2) * _TO_DEGF),
                                float(_f32(lon2) * _TO_DEGF))


def _sphere_rad(lat1, lon1, lat2, lon2) -> float:
    d = 2 * 6384000
    a = (math.sin(0.5 * (lat1 - lat2)) ** 2
         + math.cos(lat1) * math.cos(lat2)
         * math.sin(0.5 * (lon1 - lon2)) ** 2)
    return float(_f32(d * math.asin(min(1.0, math.sqrt(a)))))


_LAT_MINUTE = 1861.57
_LON_MINUTE = [1855.32, 1848.31, 1827.32, 1792.51,
               1744.12, 1682.50, 1608.10, 1521.47,
               1423.23, 1314.11, 1194.93, 1066.57,
               930.00, 786.26, 636.44, 481.70,
               323.22, 162.24, 0.0]
_TESSELATE_THRESH = 500000.0


def geo_tesselate(flat: list[float]) -> list[float]:
    """GEOPOLY2D edge tessellation (GeoTesselate, sphinxexpr.cpp):
    edges longer than 500km gain great-circle intermediate vertices so
    planar containment approximates the spherical polygon."""
    out: list[float] = []
    n = len(flat)
    for i in range(0, n, 2):
        lat1, lon1 = float(flat[i]), float(flat[i + 1])
        out.extend([lat1, lon1])
        last = i == n - 2
        lat2 = float(flat[0] if last else flat[i + 2])
        lon2 = float(flat[1] if last else flat[i + 3])
        band = int(abs(min(lat1, lat2)) // 5.0) % 18
        d = 60.0 * (_LAT_MINUTE * abs(lat1 - lat2)
                    + _LON_MINUTE[band] * abs(lon1 - lon2))
        if d <= _TESSELATE_THRESH:
            continue
        rl1, rn1 = math.radians(lat1), math.radians(lon1)
        rl2, rn2 = math.radians(lat2), math.radians(lon2)
        d = _sphere_rad(rl1, rn1, rl2, rn2)
        if d <= _TESSELATE_THRESH:
            continue
        segs = math.ceil(d / _TESSELATE_THRESH)
        arc = math.acos(math.sin(rl1) * math.sin(rl2)
                        + math.cos(rl1) * math.cos(rl2)
                        * math.cos(rn1 - rn2))
        isd = 1.0 / math.sin(arc)
        for j in range(1, segs):
            f = j / segs
            a = math.sin((1 - f) * arc) * isd
            b = math.sin(f * arc) * isd
            x = (a * math.cos(rl1) * math.cos(rn1)
                 + b * math.cos(rl2) * math.cos(rn2))
            y = (a * math.cos(rl1) * math.sin(rn1)
                 + b * math.cos(rl2) * math.sin(rn2))
            z = a * math.sin(rl1) + b * math.sin(rl2)
            out.append(math.degrees(math.atan2(z, math.hypot(x, y))))
            out.append(math.degrees(math.atan2(y, x)))
    return out
