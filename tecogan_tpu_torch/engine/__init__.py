"""Model construction and the recurrent clip inference."""
