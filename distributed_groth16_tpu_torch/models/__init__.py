"""Model families of the port: groth16."""
