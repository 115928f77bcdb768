"""Model zoo of the port: the CNNs of the image, detection, pose and audio
paths, the LSTM, and the transformer family (encoder, decode cell, ViT, the
byte-level text classifier)."""
