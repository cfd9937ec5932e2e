from repro_torch.data.synthetic import (
    lm_batch, make_train_data_fn, synthetic_reports, report_tokens,
    poisson_arrivals,
)
