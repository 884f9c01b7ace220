"""Port models: wav2vec2-XLSR front-end, AASIST back-end, zoo, registry."""
