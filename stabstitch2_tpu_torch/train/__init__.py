"""The three trainers (spatial, temporal, smooth), their losses, the
epoch loops and the motion export between the stages."""
