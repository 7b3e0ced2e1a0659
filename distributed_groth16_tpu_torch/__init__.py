"""distributed_groth16_tpu_torch — the PyTorch/CUDA port of
distributed_groth16_tpu, for one NVIDIA Hopper card (H100).

The JAX package beside it stays the reference; this package mirrors its
layout and names so each module has an obvious counterpart:

    ops/       field, curve and limb-major arithmetic, NTT, MSM, the
               fixed-scalar ladder; the four hand-written CUDA kernels
               (csrc/) and the module that compiles them (ops/_cuda.py)
    parallel/  the n-party star (in-process LocalSimNet), packed secret
               sharing, the in-exponent point NTT, d_fft, d_msm, deg_red
               and d_pp
    models/    groth16 setup / prove_single / CRS packing and the MPC
               prover (distributed_prove_party) / verify
    frontend/  R1CS builder and the SHA-256 circuit
    utils/     the transport's NetConfig

Rules the port keeps:

  * it imports torch, never jax, and nothing of distributed_groth16_tpu
    (pure-Python helpers it needs are copied here);
  * field elements are int32 tensors of shape (..., 16): sixteen 16-bit
    Montgomery limbs, the JAX package's layout;
  * entry points (setup, ProvingKey.load, PrimeField.encode) default to
    device "cuda"; only an explicit device="cpu" runs on the CPU, where
    every kernel wrapper takes its plain PyTorch version. On a CUDA tensor
    a wrapper launches its kernel or raises. Kernels are compiled with
    nvcc at their first use, never at import.
"""
