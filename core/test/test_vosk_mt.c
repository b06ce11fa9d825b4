/* Multi-threaded C ABI test: one model, N recognizers in N threads —
 * the core threading contract of the reference API
 * (/root/reference/src/vosk_api.h:24-27: "concurrent processing of
 * multiple audio streams ... recognizers here are not thread safe
 * [individually], one per thread").
 *
 * Each thread decodes the same WAV through its own recognizer; the test
 * checks every thread produced the identical (non-empty) final result and
 * prints single-thread vs aggregate throughput, quantifying how much the
 * embedded-CPython shim's GIL serializes the ABI (the honest cost of the
 * Python-core design; the accelerator itself is one shared device anyway). */
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "vosk_api.h"

#define MAX_THREADS 16
#define MAX_WAV (16 * 1024 * 1024)

static char *wav_data;
static long wav_len;
static VoskModel *model;
static char results[MAX_THREADS][8192];

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static void *worker(void *arg) {
  int id = (int)(long)arg;
  VoskRecognizer *rec = vosk_recognizer_new(model, 16000.0);
  if (!rec) {
    snprintf(results[id], sizeof(results[id]), "ERROR:create");
    return NULL;
  }
  vosk_recognizer_set_words(rec, 1);
  vosk_recognizer_set_word_times(rec, 1);
  long pos = 44; /* skip RIFF header */
  while (pos < wav_len) {
    int n = wav_len - pos > 3200 ? 3200 : (int)(wav_len - pos);
    if (vosk_recognizer_accept_waveform(rec, wav_data + pos, n) < 0) {
      snprintf(results[id], sizeof(results[id]), "ERROR:accept");
      vosk_recognizer_free(rec);
      return NULL;
    }
    pos += n;
  }
  snprintf(results[id], sizeof(results[id]), "%s",
           vosk_recognizer_final_result(rec));
  vosk_recognizer_free(rec);
  return NULL;
}

int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s <model-dir> <wav> <threads>\n", argv[0]);
    return 2;
  }
  int nthreads = atoi(argv[3]);
  if (nthreads < 1 || nthreads > MAX_THREADS) return 2;

  FILE *f = fopen(argv[2], "rb");
  if (!f) return 1;
  wav_data = malloc(MAX_WAV);
  wav_len = (long)fread(wav_data, 1, MAX_WAV, f);
  fclose(f);
  double audio_s = (wav_len - 44) / 2.0 / 16000.0;

  vosk_set_log_level(-1);
  model = vosk_model_new(argv[1]);
  if (!model) return 1;

  /* single-thread baseline (also warms compiles) */
  double t0 = now_s();
  worker((void *)0L);
  double single = now_s() - t0;

  pthread_t tids[MAX_THREADS];
  t0 = now_s();
  for (long i = 0; i < nthreads; i++)
    pthread_create(&tids[i], NULL, worker, (void *)i);
  for (int i = 0; i < nthreads; i++) pthread_join(tids[i], NULL);
  double multi = now_s() - t0;

  for (int i = 0; i < nthreads; i++) {
    if (strncmp(results[i], "ERROR", 5) == 0 ||
        strcmp(results[i], results[0]) != 0) {
      fprintf(stderr, "thread %d mismatch: %s\n", i, results[i]);
      return 1;
    }
  }
  printf("RESULT %s\n", results[0]);
  double scaling = (nthreads * audio_s / multi) / (audio_s / single);
  printf("THROUGHPUT single %.2f audio-s/s, %d threads %.2f audio-s/s "
         "(scaling x%.2f)\n",
         audio_s / single, nthreads, nthreads * audio_s / multi, scaling);
  /* N recognizers over one shared Model must overlap (the reference's
   * threading contract, vosk_api.h:24-27): the shared decoder + jax's
   * GIL-released device waits give real concurrency even through the
   * embedded-CPython bridge (r5 measured x2.06 at 4 threads on 2 cores).
   * Override the floor with VOSK_MT_MIN_SCALING (0 disables). */
  double min_scaling = 1.5;
  const char *ms = getenv("VOSK_MT_MIN_SCALING");
  if (ms) min_scaling = atof(ms);
  if (nthreads >= 4 && min_scaling > 0 && scaling < min_scaling) {
    fprintf(stderr, "FAIL: scaling x%.2f below required x%.2f\n",
            scaling, min_scaling);
    return 3;
  }
  vosk_model_free(model);
  free(wav_data);
  return 0;
}
