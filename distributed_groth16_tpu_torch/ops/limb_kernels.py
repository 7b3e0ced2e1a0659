"""Limb-major field and group arithmetic, the tree MSM, and kernels 1-3 —
the counterpart of distributed_groth16_tpu/ops/limb_kernels.py.

Field elements live limb-major: int32 tensors (nl, n), limb rows first,
batch along the columns, Montgomery form, REDUNDANT residues in [0, 2p):
`mul` has no final subtraction (inputs < 2p give < 2p since 4p < 2^(16nl)),
add/sub do one conditional -2p, and values are canonicalised only at the
boundary back to the row-major world (`to_rowmajor`). nl = 16 for BN254
(8 32-bit words), 24 for BLS12-377/381 (12 words).

Points are (3*CR, n) tensors, rows X, Y, Z (CR = nl for G1 over Fq, 2*nl
for G2 over Fq2). `LimbGroup.add`, `double` and `horner` are the wrappers
of the hand-written CUDA kernels in csrc/limb_group.cu (the replacements
of the Pallas kernels _pallas_add, _pallas_double and _horner),
instantiated at 8 and 12 words: a CUDA tensor launches the kernel, a CPU
tensor runs the plain PyTorch version below, which performs the same
field operations in the same order, so both give identical limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from .constants import LIMB_BITS, N_LIMBS, Q, to_limbs
from .field import (
    _comp_np,
    _Consts,
    _add_mod,
    _cond_sub,
    _mont_mul,
    _neg_mod,
    _sub_mod,
)

NL = N_LIMBS


def _words(limbs) -> list[int]:
    """16-bit limbs -> 32-bit words (the kernels' element layout)."""
    limbs = [int(v) for v in limbs]
    return [limbs[2 * i] | (limbs[2 * i + 1] << 16)
            for i in range(len(limbs) // 2)]


def _stack(*xs):
    """Stack same-field operands on a new axis 1 (after the limb axis) so
    independent field ops run as one batched call."""
    return torch.stack(torch.broadcast_tensors(*xs), dim=1)


class LimbField:
    """Montgomery arithmetic on limb-major int64 tensors (nl, ...) holding
    values in [0, 2p). Operands broadcast over the trailing axes."""

    def __init__(self, modulus: int, nl: int = NL):
        assert 4 * modulus < 1 << (LIMB_BITS * nl), "lazy-carry redundancy"
        self.p = modulus
        self.nl = nl
        self.CR = nl
        self.p_col = np.array(to_limbs(modulus, nl), np.int32).reshape(nl, 1)
        self.p2_col = np.array(
            to_limbs(2 * modulus, nl), np.int32
        ).reshape(nl, 1)
        self.mont_r = (1 << (LIMB_BITS * nl)) % modulus
        mbits = LIMB_BITS * nl
        pinv = (-pow(modulus, -1, 1 << mbits)) % (1 << mbits)
        def col(x):
            return np.array(to_limbs(x, nl), np.int64)

        self._c = _Consts(
            p=col(modulus), pneg=col((1 << mbits) - modulus),
            p2=col(2 * modulus), p2neg=col((1 << mbits) - 2 * modulus),
            pinv=col(pinv), comp=_comp_np(nl),
        )
        # the kernels' FieldConsts: p, 2p (32-bit words), -p^-1 mod 2^32
        self.kernel_words = (
            _words(self.p_col[:, 0]) + _words(self.p2_col[:, 0])
            + [(-pow(modulus, -1, 1 << 32)) % (1 << 32)]
        )

    def _k(self, name, x):
        return self._c.get(name, x.device, x.ndim)

    def mul(self, a, b):
        """Montgomery product, no final subtraction: < 2p in, < 2p out."""
        return _mont_mul(a, b, self._k("p", a), self._k("pinv", a))

    def add(self, a, b):
        return _add_mod(a, b, self._k("p2", a), self._k("p2neg", a))

    def sub(self, a, b):
        return _sub_mod(a, b, self._k("p2", a), self._k("comp", a))

    def neg(self, b):
        """2p - b, the additive inverse in the redundant class."""
        return _neg_mod(b, self._k("p2", b), self._k("comp", b))

    def canon(self, a):
        """[0, 2p) carried -> canonical [0, p)."""
        return _cond_sub(a, self._k("p", a), self._k("pneg", a))

    def make_ops(self):
        """(mul, add, sub) — the interface the group-law bodies are
        written against, shared with LimbFq2."""
        return self.mul, self.add, self.sub

    def neg_rows(self, a):
        return self.neg(a)

    def canon_rows(self, a):
        return self.canon(a)

    def b3_limbs(self, b) -> np.ndarray:
        """3*b Montgomery-encoded as a (nl, 1) limb column."""
        v = 3 * b * self.mont_r % self.p
        return np.array(to_limbs(v, self.nl), np.int32).reshape(self.nl, 1)

    def one_limbs(self) -> np.ndarray:
        return np.array(to_limbs(self.mont_r, self.nl), np.int32)


class LimbFq2:
    """Fq2 = Fq[u]/(u^2 + 1) on limb-major (2*nl, ...): rows 0..nl-1 c0,
    nl..2nl-1 c1. Karatsuba over LimbField's redundant arithmetic."""

    def __init__(self, base: LimbField):
        self.fq = base
        self.nl = base.nl
        self.CR = 2 * base.nl
        self.p_col = base.p_col
        self.kernel_words = base.kernel_words

    def _split(self, a):
        """(2nl, ...) -> (nl, 2, ...): both components as one batch."""
        return a.unflatten(0, (2, self.nl)).transpose(0, 1)

    @staticmethod
    def _join(a):
        return a.transpose(0, 1).flatten(0, 1)

    def make_ops(self):
        F = self.fq

        def mul(a, b):
            a, b = torch.broadcast_tensors(a, b)
            A, B = self._split(a), self._split(b)
            a0, a1, b0, b1 = A[:, 0], A[:, 1], B[:, 0], B[:, 1]
            s = F.add(_stack(a0, b0), _stack(a1, b1))  # sa, sb
            t = F.mul(_stack(a0, a1, s[:, 0]), _stack(b0, b1, s[:, 1]))
            t0, t1, tsum = t[:, 0], t[:, 1], t[:, 2]
            c = F.sub(_stack(t0, tsum), _stack(t1, F.add(t0, t1)))
            return self._join(c)  # c0 = t0 - t1 (u^2 = -1), c1

        def add(a, b):
            return self._join(F.add(self._split(a), self._split(b)))

        def sub(a, b):
            return self._join(F.sub(self._split(a), self._split(b)))

        return mul, add, sub

    def neg_rows(self, a):
        return self._join(self.fq.neg(self._split(a)))

    def canon_rows(self, a):
        return self._join(self.fq.canon(self._split(a)))

    def b3_limbs(self, b) -> np.ndarray:
        """3*b' Montgomery-encoded as a (2*nl, 1) limb column (b' in Fq2)."""
        return np.concatenate([self.fq.b3_limbs(c) for c in b], axis=0)

    def one_limbs(self) -> np.ndarray:
        one = np.zeros((2 * self.nl,), np.int32)
        one[: self.nl] = self.fq.one_limbs()
        return one


@functools.cache
def lfq() -> LimbField:
    return LimbField(Q)


@functools.cache
def lfq2() -> LimbFq2:
    return LimbFq2(lfq())


# ---------------------------------------------------------------------------
# Group law on limb-major points (3*CR, n): X rows then Y then Z
# (projective, RCB16 complete formulas, a = 0).
# ---------------------------------------------------------------------------


class LimbGroup:
    """A short-Weierstrass group (a = 0) on limb-major int32[3*CR, n]."""

    def __init__(self, field, b):
        self.F = field
        self.CR = field.CR
        self.ROWS = 3 * self.CR
        self.base_nl = field.p_col.shape[0]
        self.deg = self.CR // self.base_nl
        self.nw = self.base_nl // 2  # the kernels' 32-bit word count
        b3 = field.b3_limbs(b)
        self._b3 = _Consts(b3=b3[:, 0])
        # csrc/limb_group.cu GroupConsts: p, 2p, 3b words, n0
        w = field.kernel_words
        self.kernel_consts = np.array(
            w[:-1] + _words(b3[:, 0]) + w[-1:], dtype=np.uint32
        )
        inf = np.zeros((self.ROWS,), np.int32)
        inf[self.CR : self.CR + field.one_limbs().shape[0]] = (
            field.one_limbs()
        )
        self.inf_col = inf.reshape(self.ROWS, 1)

    # -- plain bodies (int64, limb-major (ROWS, ...)) -------------------------
    # Independent field ops of one formula step run stacked as one call;
    # each value is the same function of the same operands as in the
    # kernel, so stacking changes no limb.

    def add_body(self, p3, q3):
        CR = self.CR
        mul, add, sub = self.F.make_ops()
        b3 = self._b3.get("b3", p3.device, p3.ndim + 1)
        X1, Y1, Z1 = p3[0:CR], p3[CR : 2 * CR], p3[2 * CR :]
        X2, Y2, Z2 = q3[0:CR], q3[CR : 2 * CR], q3[2 * CR :]
        s = add(_stack(X1, Y1, X1, X2, Y2, X2), _stack(Y1, Z1, Z1, Y2, Z2, Z2))
        r1 = mul(
            _stack(X1, Y1, Z1, s[:, 0], s[:, 1], s[:, 2]),
            _stack(X2, Y2, Z2, s[:, 3], s[:, 4], s[:, 5]),
        )
        t0, t1, t2 = r1[:, 0], r1[:, 1], r1[:, 2]
        d = sub(r1[:, 3:6], add(_stack(t0, t1, t0), _stack(t1, t2, t2)))
        t3, t4, ty = d[:, 0], d[:, 1], d[:, 2]
        t0_3 = add(add(t0, t0), t0)
        r2 = mul(_stack(t2, ty), b3)
        t2b, yb = r2[:, 0], r2[:, 1]
        Z3 = add(t1, t2b)
        t1m = sub(t1, t2b)
        r3 = mul(
            _stack(t3, t4, yb, t1m, Z3, t0_3),
            _stack(t1m, yb, t0_3, Z3, t4, t3),
        )
        X3 = sub(r3[:, 0], r3[:, 1])
        YZ = add(_stack(r3[:, 2], r3[:, 4]), _stack(r3[:, 3], r3[:, 5]))
        return torch.cat([X3, YZ[:, 0], YZ[:, 1]], dim=0)

    def double_body(self, p3):
        CR = self.CR
        mul, add, sub = self.F.make_ops()
        b3 = self._b3.get("b3", p3.device, p3.ndim)
        X, Y, Z = p3[0:CR], p3[CR : 2 * CR], p3[2 * CR :]
        r1 = mul(_stack(Y, Y, Z, X), _stack(Y, Z, Z, Y))
        t0, t1, t2, txy = r1[:, 0], r1[:, 1], r1[:, 2], r1[:, 3]
        z8 = add(t0, t0)
        z8 = add(z8, z8)
        z8 = add(z8, z8)  # 8 Y^2
        t2b = mul(t2, b3)
        y3a = add(t0, t2b)
        t0m = sub(t0, add(add(t2b, t2b), t2b))
        r3 = mul(_stack(t2b, t1, t0m, t0m), _stack(z8, z8, y3a, txy))
        X3g, Z3, Y3m, X3m = r3[:, 0], r3[:, 1], r3[:, 2], r3[:, 3]
        Y3 = add(X3g, Y3m)
        X3 = add(X3m, X3m)
        return torch.cat([X3, Y3, Z3], dim=0)

    def neg_body(self, p3):
        CR = self.CR
        return torch.cat(
            [p3[0:CR], self.F.neg_rows(p3[CR : 2 * CR]), p3[2 * CR :]], dim=0
        )

    @staticmethod
    def _by_columns(body, *xs):
        """body over (ROWS, n) operands in int64. On the CPU it runs in
        blocks of 8192 columns, which keep a block's intermediates in
        cache (about twice as fast at tree-MSM widths)."""
        n = xs[0].shape[1]
        step = 8192 if xs[0].device.type == "cpu" else n
        if n <= step:
            return body(*(x.long() for x in xs))
        return torch.cat(
            [body(*(x[:, i : i + step].long() for x in xs))
             for i in range(0, n, step)],
            dim=1,
        )

    def plain_add(self, p, q):
        """Plain version of kernel 1 (the JAX package's _xla_add)."""
        RR = self.ROWS
        q = q.expand(p.shape)
        out = self._by_columns(
            self.add_body, p.reshape(RR, -1), q.reshape(RR, -1)
        )
        return out.to(torch.int32).reshape(p.shape)

    def plain_double(self, p):
        """Plain version of kernel 2 (the JAX package's _xla_double)."""
        out = self._by_columns(self.double_body, p.reshape(self.ROWS, -1))
        return out.to(torch.int32).reshape(p.shape)

    def plain_horner(self, s, c: int):
        """Plain version of kernel 3: acc = sum_w 2^(c*w) * S_w over the W
        columns of s (ROWS, W), LSB window first -> (ROWS, 1)."""
        x = s.long()
        W = x.shape[1]
        acc = x[:, W - 1 : W]
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                acc = self.double_body(acc)
            acc = self.add_body(acc, x[:, w : w + 1])
        return acc.to(torch.int32)

    # -- kernel wrappers ----------------------------------------------------

    def _kernel(self, op: str) -> _cuda.Kernel:
        """Kernel `op` instantiated at this group's word count and degree,
        with its own launch counter (ops/_cuda.KERNELS)."""
        return _cuda.KERNELS[_cuda.kernel_name(op, self.deg, self.nw)]

    def _cols(self, name, t):
        """(ROWS, ...) -> a (ROWS, N) view (copied only if not viewable)
        the kernel reads through its row and column strides."""
        _cuda.check_cuda_int32(name, t)
        return t.reshape(self.ROWS, -1)

    def add(self, p, q):
        """Complete add on (ROWS, ...) batches; q broadcasts to p.

        Kernel 1 on a CUDA tensor, its plain version on a CPU tensor."""
        if p.device.type == "cpu":
            return self.plain_add(p, q)
        a = self._cols("add p", p)
        b = self._cols("add q", q.expand(p.shape))
        n = a.shape[1]
        out = torch.empty((self.ROWS, n), dtype=torch.int32, device=p.device)
        if n:
            self._kernel("add")(
                self.deg, self.nw,
                a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                out.data_ptr(), n, self.kernel_consts.ctypes.data,
                _cuda.stream_ptr(out),
            )
        return out.reshape(p.shape)

    def double(self, p):
        """Complete doubling: kernel 2 on CUDA, plain version on CPU."""
        if p.device.type == "cpu":
            return self.plain_double(p)
        a = self._cols("double p", p)
        n = a.shape[1]
        out = torch.empty((self.ROWS, n), dtype=torch.int32, device=p.device)
        if n:
            self._kernel("double")(
                self.deg, self.nw,
                a.data_ptr(), a.stride(0), a.stride(1),
                out.data_ptr(), n, self.kernel_consts.ctypes.data,
                _cuda.stream_ptr(out),
            )
        return out.reshape(p.shape)

    def neg(self, p):
        return self.neg_body(p.reshape(self.ROWS, -1).long()).to(
            torch.int32
        ).reshape(p.shape)

    # kernel 3 stages at most this many window sums in shared memory
    # (csrc/limb_group.cu kHornerMaxW): W = 68 is c = 4 over the 17-limb
    # standard form of an Fr381 share (272 bits, the top 17 windows zero)
    HORNER_MAX_W = 68

    def horner(self, s, c: int):
        """Window sums s (ROWS, W), LSB window first -> one point column:
        kernel 3 on CUDA, plain version on CPU."""
        W = s.shape[1]
        if W == 1:
            return s
        if s.device.type == "cpu":
            return self.plain_horner(s, c)
        _cuda.check_cuda_int32("horner s", s)
        if W > self.HORNER_MAX_W or c < 1:
            raise ValueError(
                f"horner: kernel 3 takes 2 <= W <= {self.HORNER_MAX_W} "
                f"window sums and c >= 1, got W = {W}, c = {c}"
            )
        s = s.contiguous()
        out = torch.empty((self.ROWS, 1), dtype=torch.int32, device=s.device)
        self._kernel("horner")(
            self.deg, self.nw, s.data_ptr(), W, c,
            out.data_ptr(), self.kernel_consts.ctypes.data,
            _cuda.stream_ptr(out),
        )
        return out

    # -- layout conversion ---------------------------------------------------

    @property
    def rm_shape(self) -> tuple:
        """Trailing row-major point shape: (3, nl) G1, (3, 2, nl) G2."""
        bn = self.base_nl
        return (3, bn) if self.CR == bn else (3, 2, bn)

    def from_rowmajor(self, pts):
        """(n,) + rm_shape row-major (canonical Montgomery) -> (ROWS, n)."""
        return pts.reshape(pts.shape[0], self.ROWS).t().contiguous()

    def to_rowmajor(self, lm, canonical: bool = True):
        """(ROWS, n) -> (n,) + rm_shape row-major; canonicalises to [0, p)."""
        if canonical:
            x = lm.long()
            lm = torch.cat(
                [
                    self.F.canon_rows(x[i * self.CR : (i + 1) * self.CR])
                    for i in range(3)
                ],
                dim=0,
            ).to(torch.int32)
        return lm.t().reshape((-1,) + self.rm_shape).contiguous()

    def infinity(self, n: int, device):
        return torch.as_tensor(self.inf_col, device=device).expand(
            self.ROWS, n
        )


@functools.cache
def lg1() -> LimbGroup:
    from .constants import G1_B

    return LimbGroup(lfq(), G1_B)


@functools.cache
def lg2() -> LimbGroup:
    from .constants import G2_B

    return LimbGroup(lfq2(), G2_B)


# BLS12-377/381 limb groups: the same bodies and kernels at 24 base-field
# limb rows (radix 2^384, 12-word kernel instantiations), keyed off the
# constants derived in ops/bls12_377.py and ops/bls12_381.py.


@functools.cache
def lg1_377() -> LimbGroup:
    from .bls12_377 import G1_B377, Q377, fq377

    return LimbGroup(LimbField(Q377, fq377().nl), G1_B377)


@functools.cache
def lg1_381() -> LimbGroup:
    from .bls12_381 import G1_B381, Q381, fq381

    return LimbGroup(LimbField(Q381, fq381().nl), G1_B381)


@functools.cache
def lg2_381() -> LimbGroup:
    from .bls12_381 import G2_B381, Q381, fq381

    return LimbGroup(LimbFq2(LimbField(Q381, fq381().nl)), G2_B381)


# ---------------------------------------------------------------------------
# Tree MSM: sorted-digit buckets, pairwise sum tree + Fenwick prefix queries
# ---------------------------------------------------------------------------


def _digits(scalars_std, c: int):
    """(n, nl) standard-form limbs -> (W, n) int64 c-bit digits, LSB window
    first, W = nl*16/c. c must divide 16. Width-aware: a wider layout (the
    17-limb standard form of an Fr381 share) just gives more, all-zero,
    top windows."""
    assert LIMB_BITS % c == 0
    per = LIMB_BITS // c
    s = scalars_std.long()
    parts = [(s >> (k * c)) & ((1 << c) - 1) for k in range(per)]
    inter = torch.stack(parts, dim=-1).reshape(s.shape[0], s.shape[1] * per)
    return inter.t().contiguous()


def msm_tree(points_rm, scalars_std, c: int | None = None,
             window_group: int | None = None, group: LimbGroup = None):
    """sum_i scalars[i] * points[i] on the limb-major path.

    points_rm: (n, 3, nl) G1 / (n, 3, 2, nl) G2 projective row-major
    (Montgomery, canonical); `group` is their LimbGroup (None: BN254's,
    from the rank); scalars_std: (n, k) standard-form limbs, k*16 at
    least the scalar bits. Returns the (3, ...) row-major canonical
    projective sum.

    Per window: points are ordered by digit (stable argsort), reduced by a
    pairwise sum tree (n-1 adds, every level one kernel-1 launch over all
    windows at once), and the B-1 bucket prefix sums C_j are read off the
    tree Fenwick-style: C(pos) = sum_{d: bit d of pos} level_d[(pos>>d)-1].
    sum_b b*S_b = sum_j (total - C_j) then takes one batched neg + add and
    a small tree sum; the windows combine in one Horner launch (kernel 3).
    """
    n = points_rm.shape[0]
    if c is None:
        # the Fenwick/combine stages scale with B = 2^c per window: a small
        # MSM with c=8 would spend everything on 255 empty buckets
        c = 8 if n >= 4096 else 4
    g = group or (lg2() if points_rm.ndim == 4 else lg1())
    dev = points_rm.device
    RR = g.ROWS
    W_all = scalars_std.shape[1] * LIMB_BITS // c
    B = 1 << c
    npad = 1 << max(1, (n - 1).bit_length())
    lm = g.from_rowmajor(points_rm)
    digits = _digits(scalars_std, c)  # (W, n)
    if npad != n:
        lm = torch.cat([lm, g.infinity(npad - n, dev)], dim=1)
        digits = torch.nn.functional.pad(digits, (0, npad - n))
    levels_n = npad.bit_length() - 1
    if window_group is None:
        window_group = W_all if npad <= (1 << 17) else max(1, 8 * 48 // RR)
    inf = torch.as_tensor(g.inf_col, device=dev)  # (RR, 1)
    bucket_ids = torch.arange(B - 1, device=dev)

    sums = []
    for w0 in range(0, W_all, window_group):
        dg = digits[w0 : w0 + window_group]  # (Wg, npad)
        Wg = dg.shape[0]
        order = torch.argsort(dg, dim=-1, stable=True)
        sortd = torch.gather(dg, -1, order)
        ends = torch.searchsorted(
            sortd, bucket_ids.expand(Wg, B - 1).contiguous(), right=True
        )  # (Wg, B-1)
        x = lm[:, order.reshape(-1)].reshape(RR, Wg, npad)

        # up-sweep, keeping every level for the Fenwick queries
        levels = [x]
        for _ in range(levels_n):
            k = x.shape[-1]
            pair = x.reshape(RR, Wg, k // 2, 2)
            x = g.add(pair[..., 0], pair[..., 1])
            levels.append(x)
        total = x[..., 0:1]  # (RR, Wg, 1)

        # Fenwick prefix at the B-1 bucket boundaries: one node per level
        # per boundary, then the levels summed by a pairwise tree
        rows = torch.arange(Wg, device=dev)[:, None]
        nodes = []
        for d in range(levels_n + 1):
            pd = ends >> d
            take = ((pd & 1) == 1)[None]
            k = npad >> d
            flat = (rows * k + (pd - 1).clamp(min=0)).reshape(-1)
            node = levels[d].reshape(RR, -1)[:, flat].reshape(RR, Wg, B - 1)
            nodes.append(torch.where(take, node, inf[:, :, None]))
        D = len(nodes)
        dpad = 1 << (D - 1).bit_length()
        nodes += [inf[:, :, None].expand(RR, Wg, B - 1)] * (dpad - D)
        stack = torch.stack(nodes, dim=1)  # (RR, dpad, Wg, B-1)
        while stack.shape[1] > 1:
            half = stack.shape[1] // 2
            stack = g.add(stack[:, :half], stack[:, half:])
        acc = stack[:, 0]  # (RR, Wg, B-1)

        # sum_b b * S_b = sum_{j=0..B-2} (total - C_j)
        terms = g.add(total.expand(acc.shape), g.neg(acc))
        k = B - 1
        while k > 1:
            if k % 2:
                terms = torch.cat(
                    [terms, inf[:, :, None].expand(RR, Wg, 1)], dim=-1
                )
                k += 1
            pair = terms.reshape(RR, Wg, k // 2, 2)
            terms = g.add(pair[..., 0], pair[..., 1])
            k //= 2
        sums.append(terms[..., 0])  # (RR, Wg)

    s_all = torch.cat(sums, dim=1)  # (RR, W_all)
    out = g.horner(s_all, c)  # (RR, 1)
    return g.to_rowmajor(out)[0]


# ---------------------------------------------------------------------------
# Fixed-scalar ladder application: out[..., o] = sum_k M[o][k] * pts[..., k]
# (the in-the-exponent PSS pack/unpack maps, parallel/pss.py): a batched
# add/double/select sweep on limb-major tensors, so every add is a kernel-1
# launch and every doubling a kernel-2 launch on a CUDA tensor.
# ---------------------------------------------------------------------------


def ladder_apply(g: LimbGroup, pts_lm, bits, signs, nbits: int):
    """pts_lm: (ROWS, B, K) limb-major bases (already GLV-expanded when the
    caller uses the endomorphism); bits: (o, K, nbits) 0/1; signs: (o, K)
    bool or None, on pts_lm's device. Returns (ROWS, B, o) limb-major
    points.

    Per ladder step: one add at (ROWS, B*o*K) columns and one doubling at
    (ROWS, B*K). Without signs the addend (ROWS, B, 1, K) is broadcast to
    the accumulator's shape, which the add wrapper copies once per step."""
    RR = g.ROWS
    B, K = pts_lm.shape[1], pts_lm.shape[2]
    o = bits.shape[0]
    inf = torch.as_tensor(g.inf_col, device=pts_lm.device).reshape(
        RR, 1, 1, 1
    )
    acc = inf.expand(RR, B, o, K)
    base = pts_lm
    for i in range(nbits):
        bit = bits[..., i]  # (o, K)
        addend = base[:, :, None, :]  # (ROWS, B, 1, K)
        if signs is not None:
            # (o, K) broadcasts against (ROWS, B, 1, K) -> (ROWS, B, o, K)
            addend = torch.where(signs, g.neg(addend), addend)
        cand = g.add(acc, addend)
        acc = torch.where(bit == 1, cand, acc)
        base = g.double(base)
    # pairwise tree-sum over the K axis (padded with infinity if odd)
    k = K
    x = acc
    while k > 1:
        if k % 2:
            x = torch.cat([x, inf.expand(RR, B, o, 1)], dim=-1)
            k += 1
        pair = x.reshape(RR, B, o, k // 2, 2)
        x = g.add(pair[..., 0], pair[..., 1])
        k //= 2
    return x[..., 0]  # (ROWS, B, o)


# ---------------------------------------------------------------------------
# Per-lane fixed-scalar ladder: out[..., j] = s_j * pts[..., j] (the lane
# twiddles and scalings of the in-exponent point NTT, parallel/pointntt.py):
# a batched add/double/select sweep on limb-major tensors, so every add is
# a kernel-1 launch and every doubling a kernel-2 launch on a CUDA tensor.
# ---------------------------------------------------------------------------


def lane_ladder(g: LimbGroup, pts_lm, bits, signs, nbits: int,
                beta: int | None = None):
    """pts_lm: (ROWS, B, n) limb-major points; bits: (P, n, nbits) 0/1 and
    signs: (P, n) bool or None, on pts_lm's device, from
    curve.fixed_scalar_ladder_tensors for the n lane scalars. P = 2 under
    GLV (part 1 acts on phi(P) = (beta X : Y : Z), so `beta` is the
    curve's GLV beta), 1 without. Returns (ROWS, B, n): lane j of every
    batch row times s_j.

    Each step adds at (ROWS, B, P, n) columns and doubles the bases there
    (no doubling after the last bit); the P parts are then combined by
    one add. A negative GLV half negates its base once before the sweep:
    the multiples of -P are the negated multiples of P."""
    RR = g.ROWS
    B, n = pts_lm.shape[1], pts_lm.shape[2]
    P = bits.shape[0]
    base = pts_lm[:, :, None, :]  # (ROWS, B, 1, n)
    if P == 2:
        CR = g.CR
        x = g.F.mul(pts_lm[:CR].long(), torch.as_tensor(
            to_limbs(beta * g.F.mont_r % g.F.p, g.base_nl),
            device=pts_lm.device).view(CR, 1, 1))
        phi = torch.cat([x.to(torch.int32), pts_lm[CR:]], dim=0)
        base = torch.cat([base, phi[:, :, None, :]], dim=2)
    if signs is not None:
        base = torch.where(signs, g.neg(base), base)
    take = bits == 1  # (P, n, nbits), selected per step as a view
    inf = torch.as_tensor(g.inf_col, device=pts_lm.device).view(RR, 1, 1, 1)
    acc = inf.expand(RR, B, P, n)
    for i in range(nbits):
        acc = torch.where(take[..., i], g.add(acc, base), acc)
        if i + 1 < nbits:
            base = g.double(base)
    if P == 1:
        return acc[:, :, 0]
    return g.add(acc[:, :, 0], acc[:, :, 1])
