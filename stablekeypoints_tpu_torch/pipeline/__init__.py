"""The runtime: frozen models and the keypoint-detection computation."""
