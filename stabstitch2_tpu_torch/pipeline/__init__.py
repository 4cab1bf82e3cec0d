"""The stitch pipelines: motion, transport, smoothing, composite; two-view
batch, online streaming and the N-view chain."""
