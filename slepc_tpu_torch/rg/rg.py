"""RG -- 2-D spectral regions (``slepc_tpu/rg/rg.py``).

Ellipse, interval (axis-aligned box), polygon and ring regions with the
inside / outside test (``check_inside``: +1 inside, 0 on the boundary, -1
outside), complement, scaling, bounding box and the contour quadrature
(``contour``: nodes and weights of the contour integral (1/2 pi i) of
f(z) dz).  The Krylov-Schur loop uses ``check_inside`` to leave out
eigenvalues outside the region (``EPS.set_rg``); the contour waits for
CISS (ROADMAP queue 1 item 11c).  Host numpy, as in the reference: a region is a few scalars and
the test runs on the ncv Ritz values of a restart.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class RG:
    """Base region.  ``check_inside`` returns +1 inside, 0 boundary, -1 out."""

    def __init__(self):
        self.complement = False
        self.sfactor = 1.0

    def set_complement(self, flg: bool = True):
        self.complement = flg

    def set_scale(self, s: float):
        self.sfactor = s

    def is_trivial(self) -> bool:
        return False

    def _inside(self, z: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def check_inside(self, z) -> np.ndarray:
        z = np.asarray(z, dtype=complex) / self.sfactor
        r = self._inside(np.atleast_1d(z))
        if self.complement:
            r = -r
        return r if np.ndim(z) else r[0]

    def contour(self, npoints: int) -> Tuple[np.ndarray, np.ndarray]:
        """Quadrature nodes z_j and weights w_j for (1/2πi)∮ f(z) dz —
        nodes scaled by sfactor (reference RGComputeQuadrature)."""
        raise NotImplementedError

    def bounding_box(self) -> Tuple[float, float, float, float]:
        raise NotImplementedError


class RGEllipse(RG):
    """Ellipse: center + radius + vertical scale (reference impls/ellipse)."""

    def __init__(self, center: complex = 0.0, radius: float = 1.0, vscale: float = 1.0):
        super().__init__()
        self.center = complex(center)
        self.radius = float(radius)
        self.vscale = float(vscale)

    def _inside(self, z):
        dx = (z.real - self.center.real) / self.radius
        dy = (z.imag - self.center.imag) / (self.radius * self.vscale)
        d = dx * dx + dy * dy
        return np.sign(1.0 - d).astype(int)

    def contour(self, npoints: int):
        th = 2 * np.pi * (np.arange(npoints) + 0.5) / npoints
        z = (self.center + self.radius * (np.cos(th) + 1j * self.vscale * np.sin(th)))
        # w_j = (z_j - center-ish derivative term)/n: dz/dθ * (1/2πi) * (2π/n)
        dz = self.radius * (-np.sin(th) + 1j * self.vscale * np.cos(th))
        w = dz / (1j * npoints)
        return z * self.sfactor, w * self.sfactor

    def bounding_box(self):
        c, r, v = self.center, self.radius, self.vscale
        s = self.sfactor
        return ((c.real - r) * s, (c.real + r) * s,
                (c.imag - r * v) * s, (c.imag + r * v) * s)


class RGInterval(RG):
    """Axis-aligned box [a,b] x [c,d] (reference impls/interval)."""

    def __init__(self, a: float = -np.inf, b: float = np.inf,
                 c: float = 0.0, d: float = 0.0):
        super().__init__()
        self.a, self.b, self.c, self.d = float(a), float(b), float(c), float(d)

    def is_trivial(self) -> bool:
        return (self.a == -np.inf and self.b == np.inf
                and self.c <= 0 <= self.d and (self.c, self.d) != (0.0, 0.0)) or (
            self.a == -np.inf and self.b == np.inf and self.c == -np.inf and self.d == np.inf)

    def _inside(self, z):
        x, y = z.real, z.imag
        if self.c == self.d == 0.0:
            # degenerate: a segment of the real axis
            inx = np.sign((x - self.a) * (self.b - x)).astype(int)
            ony = (y == 0)
            return np.where(ony, inx, -1)
        inx = np.minimum(np.sign(x - self.a), np.sign(self.b - x))
        iny = np.minimum(np.sign(y - self.c), np.sign(self.d - y))
        return np.minimum(inx, iny).astype(int)

    def contour(self, npoints: int):
        a, b, c, d = self.a, self.b, self.c, self.d
        if c == d == 0.0:
            # thin ellipse around the segment (reference uses the same trick)
            cen = 0.5 * (a + b)
            rad = 0.5 * (b - a)
            return RGEllipse(cen, rad, 0.1).contour(npoints)
        # rectangle boundary, npoints split proportionally to side lengths
        P = []
        W = []
        per = 2 * ((b - a) + (d - c))
        for (z0, z1) in (((a, c), (b, c)), ((b, c), (b, d)),
                         ((b, d), (a, d)), ((a, d), (a, c))):
            z0 = complex(*z0)
            z1 = complex(*z1)
            ns = max(1, int(round(npoints * abs(z1 - z0) / per)))
            t = (np.arange(ns) + 0.5) / ns
            P.append(z0 + t * (z1 - z0))
            W.append(np.full(ns, (z1 - z0) / ns / (2j * np.pi)))
        return (np.concatenate(P) * self.sfactor,
                np.concatenate(W) * self.sfactor)

    def bounding_box(self):
        s = self.sfactor
        return self.a * s, self.b * s, self.c * s, self.d * s


class RGPolygon(RG):
    """Polygon with complex vertices (reference impls/polygon)."""

    def __init__(self, vertices):
        super().__init__()
        self.vertices = np.asarray(vertices, dtype=complex)
        if len(self.vertices) < 3:
            raise ValueError("polygon needs >= 3 vertices")

    def _inside(self, z):
        # winding-number (crossing) test
        v = self.vertices
        res = np.empty(len(z), dtype=int)
        for i, p in enumerate(z):
            inside = False
            for j in range(len(v)):
                a, b = v[j], v[(j + 1) % len(v)]
                if (a.imag > p.imag) != (b.imag > p.imag):
                    xint = a.real + (p.imag - a.imag) * (b.real - a.real) / (b.imag - a.imag)
                    if p.real < xint:
                        inside = not inside
            res[i] = 1 if inside else -1
        return res

    def contour(self, npoints: int):
        v = self.vertices
        lens = np.abs(np.roll(v, -1) - v)
        per = lens.sum()
        P, W = [], []
        for j in range(len(v)):
            z0, z1 = v[j], v[(j + 1) % len(v)]
            ns = max(1, int(round(npoints * abs(z1 - z0) / per)))
            t = (np.arange(ns) + 0.5) / ns
            P.append(z0 + t * (z1 - z0))
            W.append(np.full(ns, (z1 - z0) / ns / (2j * np.pi)))
        return (np.concatenate(P) * self.sfactor, np.concatenate(W) * self.sfactor)

    def bounding_box(self):
        v = self.vertices * self.sfactor
        return v.real.min(), v.real.max(), v.imag.min(), v.imag.max()


class RGRing(RG):
    """Annular arc: center, radius, width, angle range (reference impls/ring)."""

    def __init__(self, center: complex = 0.0, radius: float = 1.0,
                 vscale: float = 1.0, start_ang: float = 0.0,
                 end_ang: float = 1.0, width: float = 0.1):
        super().__init__()
        self.center = complex(center)
        self.radius = float(radius)
        self.vscale = float(vscale)
        self.start_ang = float(start_ang)  # fractions of 2π
        self.end_ang = float(end_ang)
        self.width = float(width)

    def _inside(self, z):
        d = z - self.center
        r = np.hypot(d.real, d.imag / self.vscale)
        inr = np.minimum(np.sign(r - (self.radius - self.width / 2)),
                         np.sign((self.radius + self.width / 2) - r))
        ang = np.mod(np.arctan2(d.imag / self.vscale, d.real) / (2 * np.pi), 1.0)
        a0, a1 = self.start_ang, self.end_ang
        if a0 <= a1:
            ina = np.where((ang >= a0) & (ang <= a1), 1, -1)
        else:
            ina = np.where((ang >= a0) | (ang <= a1), 1, -1)
        return np.minimum(inr, ina).astype(int)

    def contour(self, npoints: int):
        n2 = npoints // 2
        a0, a1 = 2 * np.pi * self.start_ang, 2 * np.pi * self.end_ang
        if a1 <= a0:
            a1 += 2 * np.pi
        th = a0 + (a1 - a0) * (np.arange(n2) + 0.5) / n2
        zs = []
        ws = []
        for r in (self.radius + self.width / 2, self.radius - self.width / 2):
            z = self.center + r * (np.cos(th) + 1j * self.vscale * np.sin(th))
            dz = r * (-np.sin(th) + 1j * self.vscale * np.cos(th)) * (a1 - a0) / (2 * np.pi)
            zs.append(z)
            ws.append(dz / (1j * n2))
        return (np.concatenate(zs) * self.sfactor, np.concatenate(ws) * self.sfactor)

    def bounding_box(self):
        c, r, w, v, s = self.center, self.radius, self.width, self.vscale, self.sfactor
        R = r + w / 2
        return ((c.real - R) * s, (c.real + R) * s,
                (c.imag - R * v) * s, (c.imag + R * v) * s)
