// Embedded C++ program driving a ray_tpu_torch cluster through the header
// API (ray_tpu_api.h; the port's copy of native/api_demo.cc): no Python
// in this process; tasks and actors run on the cluster's pooled workers.
// Run with the cluster's addresses and the client library's path; prints
// one KEY=value line per check.
//
//   g++ -O2 -std=c++17 -Wall -o api_demo api_demo.cc -ldl
//   ./api_demo HEAD_HOST HEAD_PORT DAEMON_HOST DAEMON_PORT LIB_PATH

#include <cstdio>
#include <cstdlib>

#include "ray_tpu_api.h"

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr,
            "usage: api_demo HEAD_HOST HEAD_PORT DAEMON_HOST "
            "DAEMON_PORT LIB_PATH\n");
    return 2;
  }
  try {
    ray_tpu_api::Runtime rt;
    rt.Init(argv[1], atoi(argv[2]), argv[3], atoi(argv[4]), argv[5]);

    rt.KvPut("embedded-key", "embedded-value");
    std::string v;
    printf("KV=%s\n", rt.KvGet("embedded-key", &v) ? v.c_str() : "MISS");

    printf("PING=%ld\n", rt.Ping());

    rt.PutObject("embedded-oid", std::string(300000, 'z'));
    std::string blob;
    bool got = rt.GetObject("embedded-oid", &blob);
    printf("OBJ=%zu\n", got ? blob.size() : 0);

    auto add = rt.SubmitTask("add",
                             ray_tpu_api::Args().I(20).I(22));
    if (!add.ok) {
      printf("ADD_ERR=%s\n", add.Error().c_str());
      return 1;
    }
    printf("ADD=%lld\n", static_cast<long long>(add.AsInt()));

    auto greet = rt.SubmitTask("greet",
                               ray_tpu_api::Args().S("embedded"));
    printf("GREET=%s\n",
           greet.ok ? greet.AsString().c_str() : greet.Error().c_str());

    auto mk = rt.CreateActor("Counter", "embedded-counter",
                             ray_tpu_api::Args().I(100));
    if (!mk.ok) {
      printf("ACTOR_ERR=%s\n", mk.Error().c_str());
      return 1;
    }
    auto c1 = rt.CallActor("embedded-counter", "inc",
                           ray_tpu_api::Args().I(1));
    auto c2 = rt.CallActor("embedded-counter", "inc",
                           ray_tpu_api::Args().I(5));
    printf("COUNT1=%lld\n", static_cast<long long>(c1.AsInt()));
    printf("COUNT2=%lld\n", static_cast<long long>(c2.AsInt()));

    // app errors surface as error text, not crashes
    auto bad = rt.SubmitTask("no-such-task", ray_tpu_api::Args());
    printf("MISSING_OK=%d\n", bad.ok ? 1 : 0);
    rt.Shutdown();
    printf("DONE=1\n");
    return 0;
  } catch (const std::exception &e) {
    fprintf(stderr, "exception: %s\n", e.what());
    return 1;
  }
}
