"""What each traffic mix drives: one module per job, named by the mix."""
