"""Single-node Groth16: setup, QAP, prove_single, verify."""

from .keys import Proof, ProvingKey, VerifyingKey  # noqa: F401
from .prove import prove_single  # noqa: F401
from .qap import QAP, CompiledR1CS  # noqa: F401
from .setup import setup  # noqa: F401
from .verify import verify  # noqa: F401
