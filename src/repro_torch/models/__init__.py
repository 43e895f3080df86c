"""Model definition: parameters, layers, decoder stack, frontend stub."""
