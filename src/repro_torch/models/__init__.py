"""The LM of the port (dense family): config schema, layers, attention,
the serving ``LM`` and the converter of the reference's parameters."""
