"""Scene-folder datasets, synthetic scenes and captures, video-to-scene
conversion and the input pipeline (numpy and cv2 on the host)."""
