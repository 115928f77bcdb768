"""Model zoo of the port: MobileNet-v2 for the image-labeling pipeline."""
