"""`python -m distributed_groth16_tpu_torch.fleet` — run the fleet router."""

from .router import main

if __name__ == "__main__":
    main()
