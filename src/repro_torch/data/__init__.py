# The token data pipeline (a copy of the reference's, numpy only).
