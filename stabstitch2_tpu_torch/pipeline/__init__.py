"""The two-view stitch pipeline: motion, transport, smoothing, composite."""
