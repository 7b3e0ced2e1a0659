"""The port's counterparts of the JAX package's examples/ and scripts/
scripts, each run with `python -m distributed_groth16_tpu_torch.examples.
<name>` (on the card unless --device cpu).

Distributed runs over real sockets, one OS process per party: add_ids,
nonlocal_kernel, nonlocal_sha256, and launch, which spawns a star of them
(the role of scripts/_launch_ranks.sh and nonlocal_sha256.sh).

The reference's workloads with the n parties simulated in one process,
each with a run(...) that returns what it prints and checks:
  dfft_test         d_fft against the plain FFT (BASELINE config 3 at 2^22)
  dmsm_bench        local msm and d_msm sweep, BN254 or BLS12 (config 2:
                    BN254 G1 at 2^20, l = 1)
  dpp_test          d_pp with num = den: every prefix ratio is one
  million           the 2^20-constraint chain proved by MPC (config 4)
  local_groth_bench the per-party cost model: 6 FFTs + 5 MSMs
  sha256            the flagship: SHA-256 single-node and MPC proofs
  introspect        constraint-system statistics and a proof without MPC
  profile_msm       the tree MSM's stages by marginal cost
  profile_packing   the CRS pack in the exponent against the scalar route
  mesh_scale_run    the mesh prover, all parties on one card
"""
