"""Groth16: setup, QAP, single-node and MPC prove, verify."""

from .keys import Proof, ProvingKey, VerifyingKey  # noqa: F401
from .prove import (  # noqa: F401
    distributed_prove_party,
    pack_from_witness,
    prove_single,
    public_prove_consts,
    reassemble_proof,
)
from .proving_key import (  # noqa: F401
    PackedProvingKeyShare,
    QueryScalars,
    pack_proving_key,
    pack_proving_key_from_scalars,
)
from .qap import (  # noqa: F401
    QAP,
    CompiledR1CS,
    PackedQAPShare,
    qap_from_r1cs,
)
from .setup import setup  # noqa: F401
from .verify import verify  # noqa: F401
