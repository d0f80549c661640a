"""The gauge-equivariant flow: stripe masks, coupling layers, the stack."""
