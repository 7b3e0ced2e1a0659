"""SHA-256 as a native R1CS circuit — the framework's headline workload.

The reference's flagship benchmark proves a circom-compiled SHA-256 circuit
(fixtures/sha256, m = 32768, groth16/examples/sha256.rs). The circom
fixture's compiled wasm can't run here (no WASM runtime), so the same
workload is built natively with frontend.r1cs.ConstraintSystem: one
512-bit block, standard FIPS-180 compression in bit-level constraints.

Constraint shapes (one per bit unless noted):
  boolean b      : b*b = b
  xor z = x^y    : 2x*y = x + y - z
  ch  z = ef^(~e)g : e*(f - g) = z - g
  maj via m = bc : a*(b + c - 2m) = z - m          (2 constraints/bit)
  rot/shift      : free (wire re-indexing)
  add mod 2^32   : one linear constraint over bit-weighted sums plus
                   booleanity of the 32 output + carry bits
The per-round temp1/temp2 sums are folded directly into the e' and a'
additions (6/7-term adds) to keep the circuit inside the reference's
m = 32768 domain.

Differentially tested against hashlib.sha256 (tests/test_sha256.py).
"""

from __future__ import annotations

import hashlib
import struct

from ..ops.constants import R
from .r1cs import ConstraintSystem

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


class _Builder:
    """Word = 32 wire indices, LSB first; index -1 = constant 0."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs

    # -- wires ---------------------------------------------------------------

    def val(self, w: int) -> int:
        return 0 if w == -1 else self.cs.value(w)

    def bool_new(self, v: int) -> int:
        w = self.cs.new_witness(v & 1)
        self.cs.enforce([(1, w)], [(1, w)], [(1, w)])
        return w

    def const_word(self, k: int) -> list:
        """Constant word for linear contexts (add_words): no wires."""
        return [("const", (k >> i) & 1) for i in range(32)]

    def pinned_word(self, k: int) -> list[int]:
        """Constant word as wires pinned by one constraint per bit — for
        non-linear contexts (xor/ch/maj on the initial state)."""
        out = []
        for i in range(32):
            bit = (k >> i) & 1
            w = self.cs.new_witness(bit)
            self.cs.enforce(
                [(bit, self.cs.ONE)], [(1, self.cs.ONE)], [(1, w)]
            )
            out.append(w)
        return out

    # -- bit ops -------------------------------------------------------------

    def xor(self, x: int, y: int) -> int:
        vz = self.val(x) ^ self.val(y)
        z = self.cs.new_witness(vz)
        # 2xy = x + y - z
        self.cs.enforce(
            [(2, x)] if x != -1 else [],
            [(1, y)] if y != -1 else [],
            _lc_sub([x, y], z),
        )
        return z

    def xor3(self, x: int, y: int, z: int) -> int:
        return self.xor(self.xor(x, y), z)

    def ch(self, e: int, f: int, g: int) -> int:
        vz = (self.val(e) & self.val(f)) ^ ((1 - self.val(e)) & self.val(g))
        z = self.cs.new_witness(vz)
        # e*(f - g) = z - g
        self.cs.enforce(
            [(1, e)],
            _lc_diff(f, g),
            _lc_diff(z, g),
        )
        return z

    def maj(self, a: int, b: int, c: int) -> int:
        va, vb, vc = self.val(a), self.val(b), self.val(c)
        vm = vb & vc
        m = self.cs.new_witness(vm)
        self.cs.enforce(
            [(1, b)] if b != -1 else [],
            [(1, c)] if c != -1 else [],
            [(1, m)],
        )
        vz = (va & vb) ^ (va & vc) ^ vm
        z = self.cs.new_witness(vz)
        # a*(b + c - 2m) = z - m
        bc = []
        if b != -1:
            bc.append((1, b))
        if c != -1:
            bc.append((1, c))
        bc.append((R - 2, m))
        self.cs.enforce([(1, a)], bc, _lc_diff(z, m))
        return z

    # -- word ops ------------------------------------------------------------

    @staticmethod
    def rotr(word: list, n: int) -> list:
        return [word[(i + n) % 32] for i in range(32)]

    @staticmethod
    def shr(word: list, n: int) -> list:
        return [word[i + n] if i + n < 32 else -1 for i in range(32)]

    def word_val(self, word: list) -> int:
        acc = 0
        for i, w in enumerate(word):
            bit = w[1] if isinstance(w, tuple) else self.val(w)
            acc |= bit << i
        return acc

    def xor3_word(self, x: list, y: list, z: list) -> list:
        return [self.xor3(x[i], y[i], z[i]) for i in range(32)]

    def add_words(self, words: list[list], n_carry: int) -> list:
        """Sum words mod 2^32: allocate 32 result bits + n_carry carry bits
        and one linear constraint sum(words) == result + 2^32 * carry."""
        total = sum(self.word_val(w) for w in words)
        out_v = total & 0xFFFFFFFF
        carry_v = total >> 32
        assert carry_v < (1 << n_carry), "carry budget too small"
        out = [self.bool_new((out_v >> i) & 1) for i in range(32)]
        carry = [self.bool_new((carry_v >> i) & 1) for i in range(n_carry)]
        lc = []
        const_acc = 0
        for w in words:
            for i, bit in enumerate(w):
                if isinstance(bit, tuple):
                    const_acc += bit[1] << i
                elif bit != -1:
                    lc.append(((1 << i) % R, bit))
        if const_acc:
            lc.append((const_acc % R, self.cs.ONE))
        rhs = [((1 << i) % R, out[i]) for i in range(32)] + [
            ((1 << (32 + i)) % R, carry[i]) for i in range(n_carry)
        ]
        self.cs.enforce(lc, [(1, self.cs.ONE)], rhs)
        return out


def _lc_diff(a: int, b: int) -> list:
    lc = []
    if a != -1:
        lc.append((1, a))
    if b != -1:
        lc.append((R - 1, b))
    return lc


def _lc_sub(xs: list[int], z: int) -> list:
    lc = [(1, x) for x in xs if x != -1]
    lc.append((R - 1, z))
    return lc


def sha256_padded_block(message: bytes) -> bytes:
    """FIPS-180 padding for a single-block (<= 55 byte) message."""
    assert len(message) <= 55, "single-block circuit: message <= 55 bytes"
    bitlen = len(message) * 8
    block = message + b"\x80" + b"\x00" * (55 - len(message))
    return block + struct.pack(">Q", bitlen)


def sha256_circuit(message: bytes) -> tuple[ConstraintSystem, list[int]]:
    """Build the one-block SHA-256 circuit for `message`.

    Public inputs (2): the digest packed as two 128-bit field elements
    (big-endian halves). Private witness: the 512 padded message bits and
    all internal wires. Returns (cs, expected_public_inputs).
    """
    block = sha256_padded_block(message)
    digest = hashlib.sha256(message).digest()
    hi = int.from_bytes(digest[:16], "big")
    lo = int.from_bytes(digest[16:], "big")

    cs = ConstraintSystem()
    out_hi = cs.new_instance(hi)
    out_lo = cs.new_instance(lo)
    b = _Builder(cs)

    # message bits as boolean witnesses, words big-endian per FIPS-180
    words = []
    for w in range(16):
        word_int = struct.unpack(">I", block[4 * w : 4 * w + 4])[0]
        words.append([b.bool_new((word_int >> i) & 1) for i in range(32)])

    # message schedule
    for t in range(16, 64):
        s0 = b.xor3_word(
            b.rotr(words[t - 15], 7),
            b.rotr(words[t - 15], 18),
            b.shr(words[t - 15], 3),
        )
        s1 = b.xor3_word(
            b.rotr(words[t - 2], 17),
            b.rotr(words[t - 2], 19),
            b.shr(words[t - 2], 10),
        )
        words.append(
            b.add_words([words[t - 16], s0, words[t - 7], s1], n_carry=2)
        )

    # compression; fold temp1/temp2 into the e'/a' additions to stay
    # inside m = 32768
    state = [b.pinned_word(h) for h in _H0]
    for t in range(64):
        a, bb, c, d, e, f, g, h = state
        big_s1 = b.xor3_word(b.rotr(e, 6), b.rotr(e, 11), b.rotr(e, 25))
        ch = [b.ch(e[i], f[i], g[i]) for i in range(32)]
        big_s0 = b.xor3_word(b.rotr(a, 2), b.rotr(a, 13), b.rotr(a, 22))
        mj = [b.maj(a[i], bb[i], c[i]) for i in range(32)]
        kw = b.const_word(_K[t])
        # e' = d + h + S1 + ch + K + W   (6 terms)
        e_new = b.add_words([d, h, big_s1, ch, kw, words[t]], n_carry=3)
        # a' = h + S1 + ch + K + W + S0 + maj   (7 terms)
        a_new = b.add_words(
            [h, big_s1, ch, kw, words[t], big_s0, mj], n_carry=3
        )
        state = [a_new, a, bb, c, e_new, e, f, g]

    # digest = H0 + state, re-packed into two public field elements
    digest_words = [
        b.add_words([b.const_word(_H0[i]), state[i]], n_carry=1)
        for i in range(8)
    ]
    # hi = words 0..3 big-endian, lo = words 4..7
    def pack_lc(word_slice):
        lc = []
        for wi, word in enumerate(word_slice):
            word_shift = 32 * (3 - wi)
            for i in range(32):
                lc.append(((1 << (word_shift + i)) % R, word[i]))
        return lc

    cs.enforce(pack_lc(digest_words[:4]), [(1, cs.ONE)], [(1, out_hi)])
    cs.enforce(pack_lc(digest_words[4:]), [(1, cs.ONE)], [(1, out_lo)])
    return cs, [hi, lo]
