"""The layered forward's stage-A recursion in long double (numpy
clongdouble): the answer that float64 stage A, plain or kernel, is held
against where its own rounding is magnified (the low-frequency lanes).

No JAX, so the card's tests use it too. Each function broadcasts over the
wavenumbers ``k`` (nk,) and a frequency ``om_c``, a scalar or a column
(nf, 1) of them.
"""

import numpy as np

LD = np.clongdouble


def inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    out = np.stack([np.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                    np.stack([-m[..., 1, 0], m[..., 0, 0]], -1)], -2)
    return out / det[..., None, None]


def blocks(k, om_c, vp, vs, rho):
    sq = lambda z: np.where((z.imag == 0) & (z.real < 0), 1j * np.sqrt(-z.real), np.sqrt(z))
    w2 = om_c * om_c
    ga, gb = sq(w2 / (vp * vp) - k * k), sq(w2 / (vs * vs) - k * k)
    mu, chi, ik = rho * vs * vs, 2 * k * k - w2 / (vs * vs), 1j * k
    mat = lambda a, b, c, d: np.stack([np.stack(np.broadcast_arrays(a, b), -1),
                                       np.stack(np.broadcast_arrays(c, d), -1)], -2)
    return (mat(ik, -1j * gb, 1j * ga, ik), mat(ik, 1j * gb, -1j * ga, ik),
            mat(mu * chi, -2 * mu * k * gb, -2 * mu * k * ga, -mu * chi),
            mat(mu * chi, 2 * mu * k * gb, 2 * mu * k * ga, -mu * chi), ga, gb)


def interface(b1, b2):
    (ud1, uu1, sd1, su1), (ud2, uu2, sd2, su2) = b1[:4], b2[:4]
    iud2, iuu1 = inv2(ud2), inv2(uu1)
    rd = inv2(su1 - sd2 @ iud2 @ uu1) @ (sd2 @ iud2 @ ud1 - sd1)
    ru = inv2(sd2 - su1 @ iuu1 @ ud2) @ (su1 @ iuu1 @ uu2 - su2)
    return rd, iud2 @ (ud1 + uu1 @ rd), ru, iuu1 @ (uu2 + ud2 @ ru)


def surface_operator(model, z, k, om_c, free_surface=True, tangent=False):
    """W2, RA2, RB2, inner2 (and with ``tangent`` their z-derivatives dW2,
    dRA2, dRB2, dinner2), the port's recursion in long double, with the
    layers on each side of the source chosen in Python."""
    th, vp, vs, rho = (np.asarray(v.cpu().numpy(), np.longdouble) for v in model)
    iface = np.cumsum(th[:-1])
    tops, zbot = np.concatenate([[0], iface]), np.concatenate([iface, [np.inf]])
    blk = [blocks(k, om_c, vp[i], vs[i], rho[i]) for i in range(len(th))]
    eye = np.broadcast_to(np.eye(2, dtype=LD), blk[0][0].shape)

    def compose(s1, s2):
        x = inv2(eye - s1[2] @ s2[0])
        y = eye + s2[0] @ x @ s1[2]
        return (s1[0] + s1[3] @ s2[0] @ x @ s1[1], s2[1] @ x @ s1[1],
                s2[2] + s2[1] @ s1[2] @ y @ s2[3], s1[3] @ y @ s2[3])

    def phase(s, b, h):
        e = np.stack([np.exp(1j * b[4] * h), np.exp(1j * b[5] * h)], -1)
        return s[0], s[1] * e[..., :, None], s[2] * e[..., None, :] * e[..., :, None], \
            s[3] * e[..., None, :]

    sa = sb = (0 * eye, eye, 0 * eye, eye)
    for i in range(len(th)):
        if i > 0 and iface[i - 1] <= z:
            sa = compose(sa, interface(blk[i - 1], blk[i]))
        sa = phase(sa, blk[i], max(min(zbot[i], z) - tops[i], 0))
    for i in range(len(th) - 1):
        sb = phase(sb, blk[i], max(zbot[i] - max(tops[i], z), 0))
        if iface[i] > z:
            sb = compose(sb, interface(blk[i], blk[i + 1]))
    rf = -inv2(blk[0][2]) @ blk[0][3] if free_surface else 0 * eye
    rev = inv2(eye - sa[0] @ rf)
    ra2 = sa[2] + sa[1] @ rf @ rev @ sa[3]
    out = {"W2": (blk[0][1] + blk[0][0] @ rf) @ rev @ sa[3], "RA2": ra2, "RB2": sb[0],
           "inner2": inv2(eye - ra2 @ sb[0])}
    if tangent:
        src = blk[int(np.count_nonzero(iface <= z))]
        ig = np.stack([1j * src[4], 1j * src[5]], -1)
        sides = lambda m: ig[..., :, None] * m + m * ig[..., None, :]
        dra, drb = sides(out["RA2"]), -sides(out["RB2"])
        out.update(dW2=out["W2"] * ig[..., None, :], dRA2=dra, dRB2=drb,
                   dinner2=out["inner2"] @ (dra @ out["RB2"] + out["RA2"] @ drb) @ out["inner2"])
    return out
