"""Circuit frontends of the port: the R1CS builder and SHA-256."""
