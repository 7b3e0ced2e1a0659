"""The n-party star: transport (net), packed secret sharing (pss), the
in-exponent point NTT (pointntt), and the distributed kernels built on
them (dfft, dmsm, degred, dpp)."""
