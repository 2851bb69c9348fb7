"""Image-row bands of a frame over one or more devices."""
