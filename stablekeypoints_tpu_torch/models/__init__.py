"""UNet, VAE encoder, DDIM schedule and their building blocks."""
