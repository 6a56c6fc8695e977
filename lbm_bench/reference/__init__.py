"""The benchmark's plain reference (d2q9) of the configurations it runs."""
