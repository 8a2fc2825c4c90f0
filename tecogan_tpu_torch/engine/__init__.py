"""Model construction, the training state, recurrent clip inference, the
losses and the train step."""
