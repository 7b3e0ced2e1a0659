"""Circuit frontends of the port: the R1CS builder and SHA-256, and the
circom/snarkjs artifacts (.r1cs, .wtns, .zkey, the WASM witness VM, the
snarkjs, arkworks and Ethereum proof codecs)."""
