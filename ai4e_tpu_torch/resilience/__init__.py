"""The part of ``ai4e_tpu/resilience`` the port uses: the redelivery
backoff schedule. Breakers, retry budgets and failover are ROADMAP A18.9."""
