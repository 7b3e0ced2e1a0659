"""Host-side helpers copied from distributed_groth16_tpu/utils."""
