"""Design experiments for the port's kernels, run on the card; the package
imports nothing from here."""
